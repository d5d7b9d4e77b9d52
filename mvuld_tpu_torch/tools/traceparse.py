"""Summarize a ``torch.profiler`` trace — device time by kernel and by
category, and the device's idle share.

Usage:
  python -m mvuld_tpu_torch.tools.traceparse <trace.json or trace dir>
         [--steps K] [--top N] [--category CAT] [--json OUT]

The port's counterpart of ``mvuld_tpu/tools/traceparse.py``, which reads a
JAX profile's xplane through xprof's ``hlo_stats``. Here the input is the
Chrome trace ``torch.profiler`` writes (``prof.export_chrome_trace(path)``,
or the newest ``*.pt.trace.json`` of a ``tensorboard_trace_handler``
directory). The device's work is its events of category ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; the tool sums their durations by name
and by category (``category``: the port's CUDA kernels by pass, library
GEMMs, softmax/norm/reduce, elementwise, other), divides by ``--steps``
so totals read as ms per step, and reports the idle share of the traced
window (1 − the union of the device intervals over the span from the
trace's first event to its last). The idle time is also given by program
span: each gap between device intervals goes to the innermost ``mvuld.*``
span (``core/tracing.py``) that covers its middle on a thread that
launched kernels, or to "(no span)". ``--category`` keeps one category's
kernels in the table; ``--json`` writes the summary.

``profile_run`` is the profiling helper of ``chip_smoke.py``: one call of
a function under ``torch.profiler``, its device time by category and by
kernel printed, and its Chrome trace exported on request. The categories
and the kernel-pass tables (``MLP_PASSES``, ``DENSE_PASSES``) live here
for both.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def category(name: str) -> str:
    """The category of a device kernel by its name: the port's kernels by
    pass, then the library's."""
    if "attn_fwd_flat" in name:
        return "K1 window attention forward: the one pass"
    if "attn_fwd_stats" in name:
        return "K7/K8 window attention forward: row pass"
    if "attn_fwd_out" in name:
        return "K7/K8 window attention forward: output pass"
    if "prep_forward" in name:
        return "K1/K7/K8 window attention forward: operand prep"
    if "attn_bwd" in name or "prep_operands" in name:
        return "K2/K5/K7b/K8b window attention backward passes"
    if "dense_ln_rows" in name or (
            "DenseEpi" in name and not _backward_tag(name, "DenseEpi")):
        return "K6 dense_fwd"
    if any(k in name for k, _ in DENSE_PASSES):
        return "K6b dense_bwd"
    if "ln_rows_fwd" in name or any(
            k in name and not _backward_tag(name, k) for k in _TAGGED):
        return "K3/K4 mlp_ln"
    if any(k in name for k, _ in MLP_PASSES):
        return "K3b/K4b mlp_ln_bwd"
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "nvjet", "sm90")):
        return "library GEMM"
    if any(t in low for t in ("softmax", "reduce", "norm")):
        return "softmax/norm/reduce"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


# csrc/mlp_ln.cu's passes by a piece of their kernel's name (the GEMM
# passes by their epilogue); HiddenEpi and ZEpi serve both directions, and
# their last template argument tells the backward's instantiation
MLP_PASSES = (("HiddenEpi", "h = GELU(x·W1 + b1)"),
              ("ZEpi", "z = h·W2 + b2 (mask, residual)"),
              ("ln_rows_fwd", "LayerNorm rows"),
              ("ln_rows_bwd", "LayerNorm backward rows (dz, column partials)"),
              ("PartEpi", "dW2, dW1 (row groups)"),
              ("DhEpi", "dh = dzb·W2ᵀ · GELU′ (db1 partials)"),
              ("DxEpi", "dx = dhb·W1ᵀ + dz"),
              ("split_terms", "fp32 operands into bf16 terms"),
              ("sum_partials", "fixed-order partial sums"),
              ("sum_groups", "fixed-order partial sums"))
_TAGGED = ("HiddenEpi", "ZEpi")


def _backward_tag(name: str, key: str) -> bool:
    """Whether the epilogue ``key`` in a kernel name is the backward's: its
    last template argument is true (demangled ``…, true>``, mangled
    ``…Lb1EE``)."""
    tail = name[name.index(key) + len(key):]
    args = (tail[:tail.find(">") + 1] if tail.startswith("<")
            else tail[:tail.find("EE") + 2])
    return args.endswith("true>") or args.endswith("Lb1EE")


# csrc/fused_dense.cu's passes by a piece of their kernel's name; DenseEpi
# serves both directions (its last template argument tells the backward's)
DENSE_PASSES = (("DenseDzEpi", "dz = dy·GELU′(x·W + b) (db partials)"),
                ("DenseEpi", "x·W + b, act (y, or a or z fp32)"),
                ("dense_ln_rows", "LayerNorm rows"),
                ("dense_ln_stats", "LayerNorm backward row statistics"),
                ("dense_dz_cols", "dz, column partials"))


def dense_pass(name: str) -> str:
    """K6/K6b kernels by pass, the rest by ``category``."""
    for key, label in DENSE_PASSES + MLP_PASSES[-3:]:
        if key in name:
            return label
    return category(name)


def mlp_pass(name: str) -> str:
    """K3-K4b kernels by pass, the rest by ``category``."""
    for key, label in MLP_PASSES:
        if key in name:
            return label
    return category(name)


# --------------------------------------------------------------- traces

def find_trace(path: str) -> str:
    """``path`` itself if it is a file, else the newest ``*.json`` under it
    (a ``tensorboard_trace_handler`` directory)."""
    if os.path.isfile(path):
        return path
    hits = glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
    if not hits:
        raise SystemExit(f"no trace *.json under {path}")
    return max(hits, key=os.path.getmtime)


def load_trace(path: str) -> Dict:
    with open(path) as f:
        trace = json.load(f)
    return trace if isinstance(trace, dict) else {"traceEvents": trace}


def _union(spans: List[tuple]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no span)"


def idle_by_span(events: List[Dict], merged: List[List[float]]
                 ) -> Dict[str, float]:
    """µs of the gaps between the merged device intervals by the innermost
    ``mvuld.*`` host event that covers each gap's middle on a thread that
    launched kernels (spans nest, so the latest-starting cover), else
    ``NO_SPAN``."""
    launchers = {(e.get("pid"), e.get("tid")) for e in events
                 if e.get("cat") in LAUNCH_CATEGORIES}
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"]) for e in events
                   if e.get("cat") not in DEVICE_CATEGORIES
                   and e.get("name", "").startswith("mvuld.")
                   and (e.get("pid"), e.get("tid")) in launchers)
    starts = [a for a, _, _ in spans]
    out: Dict[str, float] = {}
    for (_, b0), (a1, _) in zip(merged, merged[1:]):
        mid, label = (b0 + a1) / 2, NO_SPAN
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if spans[j][1] >= mid:
                label = spans[j][2]
                break
        out[label] = out.get(label, 0.0) + (a1 - b0)
    return out


def summarize(trace: Dict, steps: int = 1, only: Optional[str] = None,
              top: int = 30) -> Dict:
    """The device events of a Chrome trace: total ms per step, the traced
    window, the idle share, ms per step by category, the ``top`` kernels
    by time (of category ``only`` when given) and the idle ms per step by
    program span."""
    events = [e for e in trace.get("traceEvents", [])
              if isinstance(e, dict) and e.get("ph") == "X"
              and "ts" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    K = max(steps, 1)
    by_name: Dict[str, List[float]] = {}
    for e in device:
        name = e.get("name", "")
        if e["cat"] != "kernel":
            name = f"[{e['cat']}] {name}"
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += float(e.get("dur", 0.0))
        row[1] += 1
    total_us = sum(r[0] for r in by_name.values())
    t0 = min((float(e["ts"]) for e in events), default=0.0)
    t1 = max((float(e["ts"]) + float(e.get("dur", 0.0)) for e in events),
             default=0.0)
    window_us = max(t1 - t0, 1e-9)
    merged = _union([(float(e["ts"]), float(e["ts"]) +
                      float(e.get("dur", 0.0))) for e in device])
    busy_us = sum(b - a for a, b in merged)
    idle = idle_by_span(events, merged)
    cats: Dict[str, float] = {}
    for name, (us, _) in by_name.items():
        cats[category(name)] = cats.get(category(name), 0.0) + us
    rows = [{"name": name, "category": category(name), "ms": us / 1e3 / K,
             "count": n} for name, (us, n) in by_name.items()
            if only is None or category(name) == only]
    rows.sort(key=lambda r: -r["ms"])
    return {"device_ms": total_us / 1e3 / K, "window_ms": window_us / 1e3,
            "busy_ms": busy_us / 1e3,
            "idle_share": max(0.0, 1.0 - busy_us / window_us),
            "events": len(device), "steps": K,
            "by_category": {k: v / 1e3 / K for k, v in
                            sorted(cats.items(), key=lambda kv: -kv[1])},
            "top": rows[:top],
            "idle_by_span": {k: v / 1e3 / K for k, v in
                             sorted(idle.items(), key=lambda kv: -kv[1])}}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="Chrome trace .json or a trace directory")
    ap.add_argument("--steps", type=int, default=1,
                    help="steps in the traced window (totals divided by "
                         "this → ms/step)")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--category", default=None,
                    help="only kernels of this category in the table")
    ap.add_argument("--json", default=None, help="write the summary here")
    args = ap.parse_args(argv)

    path = find_trace(args.trace)
    print(f"# {path}", file=sys.stderr)
    s = summarize(load_trace(path), args.steps, args.category, args.top)
    print(f"device time: {s['device_ms']:.3f} ms/step over {s['events']} "
          f"events; traced window {s['window_ms']:.3f} ms, idle share "
          f"{s['idle_share']:.3f}")
    grand = max(sum(s["by_category"].values()), 1e-12)
    for k, v in s["by_category"].items():
        print(f"  {k:48s} {v:9.3f} ms {v / grand:6.1%}")
    print(f"\n{'kernel':60s} {'category':24s} {'ms/step':>9s} {'n':>6s}")
    for r in s["top"]:
        print(f"{r['name'][:60]:60s} {r['category'][:24]:24s} "
              f"{r['ms']:9.3f} {r['count']:6d}")
    print(f"\n{'idle by program span':48s} {'ms/step':>9s}")
    for k, v in s["idle_by_span"].items():
        print(f"  {k:46s} {v:9.3f}")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(s, f, indent=1)
    return s


# ------------------------------------------------------------ profiling

def profile_run(label: str, fn, category_of=None,
                trace_path: Optional[str] = None) -> Dict:
    """Device time by kernel for one call of ``fn`` under torch.profiler,
    and the device's idle share of its wall time (kernels on one stream do
    not overlap, so busy time is their sum), summed by ``category_of`` of
    the kernel name (``category`` unless given) and printed. With
    ``trace_path`` the Chrome trace is exported there. Returns {"wall_ms",
    "busy_ms", "self_device_ms": key_averages()' device self time}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    category_of = category_of or category
    for _ in range(4):      # a trace now and then comes back without device
        with profile(activities=[ProfilerActivity.CPU,     # events: again
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms = e.time_range.elapsed_us() / 1e3
                by_kernel[e.name] = by_kernel.get(e.name, 0.0) + ms
        if by_kernel:
            break
    busy = max(sum(by_kernel.values()), 1e-9)
    cats = {}
    for name, ms in by_kernel.items():
        cats[category_of(name)] = cats.get(category_of(name), 0.0) + ms
    print(f"profile {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}",
          flush=True)
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}:   {cat}: {ms:.2f} ms ({ms / busy:.1%})",
              flush=True)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile {label}:     {ms:8.2f} ms  {name[:90]}", flush=True)
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "self_device_ms": self_device_ms(prof)}


def self_device_ms(prof) -> float:
    """The device self time of a profile's ``key_averages()``, summed as
    its table's "Self CUDA time total" (device events that are no user
    annotation)."""
    import torch
    total = 0.0
    for a in prof.key_averages():
        if (a.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(a, "is_user_annotation", False)):
            total += getattr(a, "self_device_time_total",
                             getattr(a, "self_cuda_time_total", 0.0))
    return total / 1e3


if __name__ == "__main__":
    main()
