"""Operations and kernel bounds of ``mvuld_e2e_base448`` (UniXcoder-base,
SwinV2-B 448, the multi_defect_new_gcn head) for the work a run did.

Training batches count every function's image and function text (all
tokens real: the traffic fills them), the code lines the packed encoder
took (valid lines up to the packing capacity, all tokens real) and the
head; serving counts each served function's real tokens and valid lines.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.counts import common

PAD = 1


def _real(ids: np.ndarray) -> np.ndarray:
    return (ids != PAD).sum(-1)


def _train_batch(m: Dict, t: Dict, b: Dict) -> Dict[str, float]:
    B = b["func_ids"].shape[0]
    n_lines = int(b["node_mask"].sum())
    if t.get("node_capacity"):
        n_lines = min(n_lines, t["node_capacity"])
    Tn = m["data"]["node_tokens"]
    func_len = _real(b["func_ids"])
    fwd = (common.swin_flops(m["swin"], B)
           + common.roberta_flops(m["text"], func_len)
           + common.roberta_flops(m["text"], [Tn] * n_lines)
           + common.head_flops(m["head"], B))
    rows = int(func_len.sum()) + n_lines * Tn
    return {"flops": 3.0 * fwd,
            "attn_s": common.swin_attention_bound(m["swin"], B, True),
            "mlp_s": (common.swin_mlp_bound(m["swin"], B, True)
                      + common.roberta_mlp_bound(m["text"], rows, True))}


def _serve_chunk(m: Dict, pool: Dict, lo: int, n: int) -> Dict[str, float]:
    sl = slice(lo, lo + n)
    func_len = _real(pool["func_ids"][sl])
    valid = pool["node_mask"][sl] > 0
    line_len = _real(pool["node_ids"][sl])[valid]
    fwd = (common.swin_flops(m["swin"], n)
           + common.roberta_flops(m["text"], func_len)
           + common.roberta_flops(m["text"], line_len)
           + common.head_flops(m["head"], n))
    rows = int(func_len.sum() + line_len.sum())
    return {"flops": fwd,
            "attn_s": common.swin_attention_bound(m["swin"], n, False),
            "mlp_s": (common.swin_mlp_bound(m["swin"], n, False)
                      + common.roberta_mlp_bound(m["text"], rows, False))}


def work(m: Dict, t: Dict, raw: Dict, traced: bool = False) -> Dict[str, float]:
    """{"flops", "attn_s", "mlp_s"} of the window's work, or with
    ``traced`` of its traced part."""
    out = {"flops": 0.0, "attn_s": 0.0, "mlp_s": 0.0}
    if raw["kind"] == "train":
        parts = [_train_batch(m, t, b)
                 for b in raw["traced_batches" if traced else "batches"]]
    else:
        step = t["max_batch"]
        parts = []
        for lo, n in raw["traced_requests" if traced else "requests"]:
            for c in range(0, n, step):       # the serving loop's chunks
                parts.append(_serve_chunk(m, raw["pool"], lo + c,
                                          min(step, n - c)))
    for p in parts:
        for k in out:
            out[k] += p[k]
    return out
