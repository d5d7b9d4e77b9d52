"""Each chunk's P(vul) to the host (span ``serve.fetch``: the wait for the
device and the copy), ms per traced request. Its note sums the serving
loop's phases against the traced requests' latency."""
from benchmark.metrics.spans import ms_per_unit, sum_against

PHASES = ("serve.input", "serve.forward", "serve.fetch")


def read(ctx):
    v = ms_per_unit(ctx, "serve", "serve.fetch", "serve_fetch_ms.serve")
    if v is not None:
        sum_against(ctx, "serve", PHASES, "serve_fetch_ms.serve")
    return v
