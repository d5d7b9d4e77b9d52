"""Operations and bytes of the measured models, from their shapes.

Model FLOPs count the products (2 per multiply-add) that these inputs
need: real tokens and valid code lines, not pads, not empty packing
capacity, not a checkpointed stage's recomputation; a training step counts
3 × its forward.

A kernel's bound is the least time the H100 could take for one launch: the
larger of its operations at the bf16 tensor-core peak, its bytes read once
and written once at the HBM peak, and, for the attention, one exp per
logit at the special-function units' rate. Launches are counted per
call, for the real rows of that call.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from benchmark.lib.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, PEAK_SFU_EXPS

BF16, FP32 = 2, 4


def _bound(flops: float, bytes_: float, exps: float = 0.0) -> float:
    return max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_HBM_BYTES,
               exps / PEAK_SFU_EXPS)


def swin_stages(s: Dict) -> List[Tuple[int, int, int, int, int]]:
    """Per stage (blocks, C, heads, tokens per side, window side)."""
    r = s["img"] // s["patch"]
    out = []
    for i, d in enumerate(s["depths"]):
        side = r // 2 ** i
        out.append((d, s["embed"] * 2 ** i, s["heads"][i], side,
                    min(s["window"], side)))
    return out


def swin_flops(s: Dict, images: int) -> float:
    """Forward FLOPs of SwinV2 on ``images`` images in one call."""
    r0 = s["img"] // s["patch"]
    f = 2.0 * images * r0 * r0 * s["chans"] * s["patch"] ** 2 * s["embed"]
    stages = swin_stages(s)
    for i, (d, C, H, side, ws) in enumerate(stages):
        L, N = images * side * side, ws * ws
        cpb = 2.0 * (2 * ws - 1) ** 2 * (2 * 512 + 512 * H)
        f += d * (24.0 * L * C * C + 4.0 * L * N * C + cpb)
        if i < len(stages) - 1:
            f += 4.0 * L * C * C
    return f


def swin_attention_bound(s: Dict, images: int, train: bool) -> float:
    """Σ over the window attention's launches (K1, and K2 in training)."""
    t = 0.0
    for d, C, H, side, ws in swin_stages(s):
        N, hd = ws * ws, C // H
        Bn = images * (side // ws) ** 2
        logits = Bn * H * N * N
        io = Bn * N * C * BF16
        fwd = _bound(4.0 * logits * hd,
                     3 * io + H * N * N * FP32 + io + Bn * H * N * FP32,
                     logits)
        bwd = _bound(10.0 * logits * hd,
                     3 * io + 2 * io + Bn * H * N * FP32 + 2 * H * N * N * FP32
                     + 3 * io, logits)
        t += d * (fwd + (bwd if train else 0.0))
    return t


def mlp_bound(M: int, C: int, train: bool) -> float:
    """One fused MLP + LayerNorm half (K3/K4, and K3b/K4b in training) on
    M rows of width C, hidden 4C."""
    Hd = 4 * C
    w = 2 * C * Hd * FP32
    fwd = _bound(4.0 * M * C * Hd, 2 * M * C * BF16 + w)
    bwd = _bound(8.0 * M * C * Hd, 3 * M * C * BF16 + 2 * w)
    return fwd + (bwd if train else 0.0)


def swin_mlp_bound(s: Dict, images: int, train: bool,
                   max_width: int = 512) -> float:
    """The fused MLP halves of the stages the kernel serves (C ≤ 512)."""
    return sum(d * mlp_bound(images * side * side, C, train)
               for d, C, H, side, ws in swin_stages(s) if C <= max_width)


def roberta_flops(t: Dict, lengths: Iterable[int]) -> float:
    """Forward FLOPs of the encoder over sequences of these real lengths."""
    H, L = t["hidden"], t["layers"]
    I = t["intermediate"]
    per = 0.0
    for T in lengths:
        per += L * (8.0 * T * H * H + 4.0 * T * H * I + 4.0 * T * T * H)
    return per


def roberta_mlp_bound(t: Dict, rows: int, train: bool) -> float:
    """K4 (and K4b) of every layer on ``rows`` token rows."""
    return t["layers"] * mlp_bound(rows, t["hidden"], train)


def head_flops(h: Dict, functions: int) -> float:
    """Forward FLOPs of the multi_defect_new_gcn head per call."""
    N, D, Hd, heads = h["max_nodes"], h["text_dim"], h["hidden"], h["heads"]
    W = Hd * heads
    f = 2.0 * N * D * W + 4.0 * N * W + 2.0 * N * N * W           # GAT 1
    f += 2.0 * N * W * W + 4.0 * N * W + 2.0 * N * N * W         # GAT 2
    f += 2.0 * N * W * Hd + h["depth"] * 2.0 * N * Hd * Hd
    f += 2.0 * N * Hd * (Hd - 32) + 2.0 * N * h["pos_dim"] * 32
    f += h["rs"] * (8.0 * N * Hd * Hd + 4.0 * N * N * Hd)
    f += 2.0 * (h["img_dim"] + h["text_dim"]) * Hd + 2.0 * 3 * Hd * h["classes"]
    return functions * f
