"""Helpers of the readers of the program's spans
(``mvuld_tpu_torch/core/tracing.py``). The program records a span only
while a profiler is open, and a run opens one once, in ``lib/trace.Traced``
around the traced part of its window, so after the window the registry
holds the traced part alone. A program without spans gives nothing to
read: the readers then return None."""

from __future__ import annotations

import statistics


def recorded(name: str):
    """The registry's entry of span ``name`` ({"n", "s", "first_ns",
    "last_ns"}), or None."""
    try:
        from mvuld_tpu_torch.core import tracing
    except ImportError:
        return None
    s = tracing.snapshot().get(name)
    return s if s and s["n"] > 0 else None


def traced_units(raw, kind: str):
    """What the traced part's spans are divided by: its optimizer steps
    (training) or its requests (serving); None where the run is of
    another kind or was not traced."""
    if raw["kind"] != kind or not raw.get("trace"):
        return None
    if kind == "train":
        return raw["trace"]["steps"]
    return len(raw["traced_requests"]) or None


def ms_per_unit(ctx, kind: str, name: str, label: str):
    """Milliseconds of span ``name`` per traced step or request."""
    units = traced_units(ctx["raw"], kind)
    s = recorded(name) if units else None
    if s is None:
        return None
    ctx["notes"].append(f"{label}: {s['n']} spans {name}, {s['s']:.6f} s "
                        f"over {units} traced "
                        f"{'steps' if kind == 'train' else 'requests'}")
    return 1e3 * s["s"] / units


def steps_per_call(raw) -> int:
    """Optimizer steps per call into the step (1, or K of a multi-step);
    a call takes one feed item."""
    return max(raw["steps"] // max(len(raw["host_step_s"]), 1), 1)


def ms_per_item(ctx, name: str, label: str):
    """Milliseconds of span ``name`` per span, per optimizer step of the
    feed item it made."""
    raw = ctx["raw"]
    s = recorded(name) if traced_units(raw, "train") else None
    if s is None:
        return None
    k = steps_per_call(raw)
    ctx["notes"].append(f"{label}: {s['n']} spans {name}, {s['s']:.6f} s, "
                        f"{k} optimizer steps an item")
    return 1e3 * s["s"] / s["n"] / k


def sum_against(ctx, kind: str, names, label: str):
    """A note: the spans ``names`` per traced step or request, summed,
    against the traced steps' host time or the traced requests' latency
    (means, ms)."""
    raw = ctx["raw"]
    units = traced_units(raw, kind)
    if not units:
        return
    parts = {n: 1e3 * s["s"] / units for n in names
             if (s := recorded(n)) is not None}
    if kind == "train":
        own = raw["host_step_s"][:units // steps_per_call(raw)]
        what = "traced steps' host time"
    else:
        own = raw["latencies_s"][:units]
        what = "traced requests' latency"
    if not parts or not own:
        return
    total, mean = sum(parts.values()), 1e3 * statistics.fmean(own)
    ctx["notes"].append(
        f"{label}: {' + '.join(parts)} = {total:.6f} ms against the {what} "
        f"{mean:.6f} ms ({100 * total / mean:.2f} %)")
