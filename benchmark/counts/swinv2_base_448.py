"""Operations and kernel bounds of ``swinv2_base_448`` (SwinV2-B at 448
with its two-class head) for the work a run did: each optimizer step at
the cell's batch."""

from __future__ import annotations

from typing import Dict

from benchmark.counts import common


def work(m: Dict, t: Dict, raw: Dict, traced: bool = False) -> Dict[str, float]:
    images = raw["traced_images" if traced else "images"]
    B = t["batch"]
    steps = images // B
    s = m["swin"]
    fwd = common.swin_flops(s, B) + 2.0 * B * s["embed"] * 2 ** (
        len(s["depths"]) - 1) * m["head"]["classes"]
    return {"flops": steps * 3.0 * fwd,
            "attn_s": steps * common.swin_attention_bound(s, B, True),
            "mlp_s": steps * common.swin_mlp_bound(s, B, True)}
