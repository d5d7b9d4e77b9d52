"""A traced part of the window: ``torch.profiler`` on the card, reduced to
the device's busy time, kernel time by name and the idle gaps.

The reduction is the arithmetic of the program's trace reader, kept here
so that the yardstick does not move with the program: the device's work is
its kernel, memcpy and memset events; busy time is the union of their
intervals; the idle share is 1 − busy over the traced window's wall time.
An idle gap is labelled by the innermost host operation that covers its
middle.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple


class Traced:
    """``with Traced() as t: ...``: profiles the block; its wall time is
    ``t.wall_s`` (from a synchronised start to a synchronised end)."""

    def __init__(self):
        self.prof, self.wall_s = None, 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(prof, wall_s: float, top: int = 10) -> Dict:
    """{"busy_s", "window_s", "kernel_s": {name: s}, "device_ops",
    "idle_gaps"} of a finished profile."""
    import torch
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    kernel_s: Dict[str, float] = {}
    for a, b, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) / 1e6
    merged = _union([(a, b) for a, b, _ in dev])
    busy = sum(b - a for a, b in merged) / 1e6
    gaps: Dict[str, float] = {}
    host.sort()
    starts = [s for s, _, _ in host]
    for (a0, b0), (a1, _) in zip(merged, merged[1:]):
        mid = (b0 + a1) / 2
        label = "(host between operations)"
        # the latest-starting host operation that covers the middle is the
        # innermost one (host operations nest)
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        gaps[label] = gaps.get(label, 0.0) + (a1 - b0) / 1e6
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": wall_s, "kernel_s": kernel_s,
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def kernel_time(trace: Dict, keys) -> float:
    """Seconds of the kernels whose names hold one of ``keys``."""
    return sum(s for name, s in trace["kernel_s"].items()
               if any(k in name for k in keys))
