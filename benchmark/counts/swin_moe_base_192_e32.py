"""Operations of ``swin_moe_base_192_e32`` (Swin-MoE-B at 192, 32 top-1
experts, two-class head) for the work a run did: each optimizer step at the
cell's batch, 3 × its forward.

A token counts once through its one expert, dense-equivalent (an MoE
layer's MLP as the dense block's), plus the gate's product; the capacity
slots left empty or holding dropped tokens are not counted, nor is the
dispatch's data movement. No kernel bound: the model runs the plain
layers.
"""

from __future__ import annotations

from typing import Dict

from benchmark.counts import common


def swin_moe_flops(s: Dict, moe: Dict, images: int) -> float:
    """Forward FLOPs of Swin-MoE (V1 blocks) on ``images`` images."""
    r0 = s["img"] // s["patch"]
    f = 2.0 * images * r0 * r0 * s["chans"] * s["patch"] ** 2 * s["embed"]
    stages = common.swin_stages(s)
    for i, (d, C, H, side, ws) in enumerate(stages):
        L, N = images * side * side, ws * ws
        hidden = s["mlp_ratio"] * C
        f += d * (8.0 * L * C * C + 4.0 * L * N * C + 4.0 * L * C * hidden)
        gated = sum(1 for j in moe["blocks"][i] if 0 <= j < d)
        f += gated * 2.0 * L * C * moe["experts"]
        if i < len(stages) - 1:
            f += 4.0 * L * C * C
    return f


def work(m: Dict, t: Dict, raw: Dict, traced: bool = False) -> Dict[str, float]:
    images = raw["traced_images" if traced else "images"]
    B = t["batch"]
    steps = images // B
    s = m["swin"]
    fwd = swin_moe_flops(s, m["moe"], B) + 2.0 * B * s["embed"] * 2 ** (
        len(s["depths"]) - 1) * m["head"]["classes"]
    return {"flops": steps * 3.0 * fwd}
