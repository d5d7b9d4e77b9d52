"""95th percentile of every request's time from the call into serve until
its P(vul) is on the host, ms."""
import statistics


def read(ctx):
    raw = ctx["raw"]
    if raw["kind"] != "serve" or len(raw["latencies_s"]) < 2:
        return None
    lat = [1e3 * s for s in raw["latencies_s"]]
    p95 = statistics.quantiles(lat, n=100, method="inclusive")[94]
    ctx["notes"].append(f"serve_request_p95_ms: median "
                        f"{statistics.median(lat):.4f} ms, p95 {p95:.4f} ms "
                        f"over {len(lat)} requests")
    by_size = {}
    for (_, n), ms in zip(raw["requests"], lat):
        by_size.setdefault(n, []).append(ms)
    ctx["notes"].append("serve_request_p95_ms by size: " + ", ".join(
        f"{n}: median {statistics.median(v):.2f} ms max {max(v):.2f} "
        f"({len(v)})" for n, v in sorted(by_size.items()) if n >= 16))
    return p95
