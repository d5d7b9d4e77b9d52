"""Tiny cells for the CPU tests: the measured configurations' shapes at
small widths, the system's plain layers in fp32, the same entries."""

from __future__ import annotations

import copy

from benchmark.lib import common

TEXT = {"vocab": 300, "hidden": 32, "layers": 2, "heads": 2, "intermediate": 64,
        "max_positions": 40, "type_vocab": 10, "pad_id": 1, "eps": 1e-5,
        "rate": 0.1}
SWIN = {"img": 64, "patch": 4, "chans": 3, "embed": 16, "depths": [2, 2],
        "heads": [2, 4], "window": 4, "pretrained": [0, 0],
        "drop_path_rate": 0.2}
HEAD = {"img_dim": 32, "text_dim": 32, "hidden": 64, "heads": 4, "depth": 2,
        "rs": 2, "max_nodes": 8, "pos_dim": 4, "classes": 2, "rate": 0.2}
DATA = {"func_tokens": 16, "node_tokens": 8, "max_nodes": 8, "img_size": 64,
        "vocab": 300}
SWIN_OPTS = ["MODEL.SWINV2.EMBED_DIM", 16, "MODEL.SWINV2.DEPTHS", [2, 2],
             "MODEL.SWINV2.NUM_HEADS", [2, 4], "MODEL.SWINV2.WINDOW_SIZE", 4,
             "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", [0, 0],
             "MODEL.DROP_PATH_RATE", 0.2, "MODEL.NUM_CLASSES", 2,
             "DATA.IMG_SIZE", 64, "PARALLEL.DTYPE", "float32",
             "TRAIN.FUSED_MLP", True, "TRAIN.USE_CHECKPOINT", True,
             "TRAIN.REMAT_STAGES", [1], "MODEL.LABEL_SMOOTHING", 0.1,
             "TRAIN.CLIP_GRAD", 5.0]
E2E_OPTS = SWIN_OPTS + [
    "MODEL.UNIXCODER.HIDDEN", 32, "MODEL.UNIXCODER.LAYERS", 2,
    "MODEL.UNIXCODER.HEADS", 2, "MODEL.UNIXCODER.INTERMEDIATE", 64,
    "MODEL.UNIXCODER.MAX_POSITIONS", 40, "DATA.FUNC_TOKENS", 16,
    "DATA.NODE_TOKENS", 8, "DATA.MAX_NODES", 8, "MODEL.MULTI.HIDDEN", 64,
    "MODEL.MULTI.NUM_RS_GCN", 2, "MODEL.MULTI.NUM_HIDDEN_FC", 2,
    "MODEL.MULTI.IMG_DIM", 32, "MODEL.MULTI.TEXT_DIM", 32,
    "TRAIN.TEXT_REMAT", "off", "TRAIN.WEIGHT_DECAY", 0.005]
OPT = {"name": "adamw", "weight_decay": 0.005, "clip": 5.0,
       "betas": [0.9, 0.999], "eps": 1e-8}
LIMITS = {"loss1": 1e-4, "loss3": 1e-4, "loss": 1e-4, "grad_rms": 1e-3,
          "grad_rms_med": 1e-3, "grad1": 1e-3, "grad1_med": 1e-3,
          "update": 1e-2, "update_med": 1e-2, "bn1": 1e-3, "p_gap": 1e-4}


def cell(name: str) -> dict:
    """The cell ``name`` with the tiny configuration in place of its own."""
    c = common.cell(name)
    kind = c["model"]["kind"]
    m = {"kind": kind, "swin": SWIN, "text": TEXT, "data": DATA,
         "head": HEAD if kind == "e2e" else {"classes": 2},
         "optimizer": OPT,
         "opts": E2E_OPTS if kind == "e2e" else SWIN_OPTS + [
             "AUG.MIXUP", 0.0, "AUG.CUTMIX", 0.0, "TRAIN.FUSED_STEPS", 2,
             "TRAIN.WEIGHT_DECAY", 0.005]}
    c = copy.deepcopy(c)
    c["model"] = copy.deepcopy(m)
    t = c["traffic"]
    for k, v in (("batch", 4), ("node_capacity", 20), ("pool_batches", 6),
                 ("fused_steps", 2), ("max_batch", 4), ("pool_rows", 24),
                 ("sample_functions", 8), ("func_tokens", [2, 12]),
                 ("line_tokens", [1, 4])):
        if k in t and not (k.endswith("tokens") and t[k] == "fill"):
            t[k] = v
    t["lines"] = [2, 6]
    if "kinds" in t:
        t["block"] = 5
        t["kinds"] = [{"share": 0.8, "range": [1, 4]},
                      {"share": 0.2, "range": [6, 9]}]
    t["blocks"] = {"text": 2, "lines": 5, "image": 3}
    c["limits"] = dict(LIMITS)
    return c
