"""Helpers the metric readers share. A reader is ``read(ctx)``: the value,
or None where its cell gives it nothing to read. ``ctx``: "raw" (the
window's record), "work" and "traced_work" (the configuration's counts of
the window and of its traced part), "setup_s", "peak_bytes" and "notes"
(lines printed before the result)."""

from __future__ import annotations

from benchmark.lib.common import PEAK_BF16_FLOPS
from benchmark.lib.trace import kernel_time

# the port's window attention kernels (csrc/window_attention.cu) and fused
# MLP + LayerNorm kernels (csrc/mlp_ln.cu), by a piece of their names
ATTENTION = ("prep_forward", "attn_fwd", "prep_operands", "attn_bwd")
MLP = ("HiddenEpi", "ZEpi", "PartEpi", "DhEpi", "DxEpi", "ln_rows_fwd",
       "ln_rows_bwd", "sum_partials", "sum_groups", "split_terms")


def mfu(ctx, kind: str, label: str):
    raw = ctx["raw"]
    if raw["kind"] != kind:
        return None
    flops = ctx["work"]["flops"]
    ctx["notes"].append(f"{label}: {flops:.6e} model FLOPs in "
                        f"{raw['window_s']:.6f} s against "
                        f"{PEAK_BF16_FLOPS:.3e} FLOP/s (bf16 dense peak)")
    return 100.0 * flops / (raw["window_s"] * PEAK_BF16_FLOPS)


def roofline(ctx, kind: str, keys, bound_key: str, label: str):
    raw = ctx["raw"]
    tr = raw.get("trace")
    if raw["kind"] != kind or not tr:
        return None
    spent = kernel_time(tr, keys)
    bound = ctx["traced_work"][bound_key]
    if spent <= 0 or bound <= 0:
        return None
    ctx["notes"].append(f"{label}: bound {bound:.6f} s over {spent:.6f} s "
                        f"of the kernels' device time in the traced part")
    return 100.0 * bound / spent


def idle(ctx, kind: str, label: str):
    raw = ctx["raw"]
    tr = raw.get("trace")
    if raw["kind"] != kind or not tr or tr["busy_s"] <= 0:
        return None
    ctx["notes"].append(f"{label}: busy {tr['busy_s']:.6f} "
                        f"s of a traced window of {tr['window_s']:.6f} s")
    return 100.0 * max(0.0, 1.0 - tr["busy_s"] / tr["window_s"])
