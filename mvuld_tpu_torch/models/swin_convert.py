"""Reference-layout Swin torch checkpoints → the port's SwinTransformerV2
and SwinTransformerV1.

Counterpart of ``mvuld_tpu/models/swin_convert.py`` ``swinv2_torch_to_flax``
for the released SwinV2 ImageNet checkpoints the reference fine-tunes from
(reference: mvuld/utils.py load_pretrained:31-141). The port's modules
carry the reference's names, so every tensor loads under its own key; what
remains is the reference's surgery:

  * the buffers ``relative_position_index``, ``relative_coords_table`` and
    ``attn_mask`` are dropped (the port rebuilds them from the geometry);
  * the classification head: an exact class count loads as it is;
    21841 → 1000 keeps the rows ``configs/map22kto1k.txt`` lists
    (utils.py:115-127); any other count is re-initialised xavier-uniform
    from ``np.random.RandomState(0)`` with the JAX converter's draws, bias 0
    (utils.py:22-28). A checkpoint without a head leaves the model's own;
  * the absolute position embedding is resampled bicubically to the
    model's patch grid (utils.py:92-112) with ``F.interpolate``, the
    reference's call. The JAX converter takes cv2's INTER_CUBIC (no cv2 on
    the card); the two agree within 1e-4 on a unit-normal embedding (same
    cubic kernel and half-pixel centres; cv2 tabulates its weights).

SwinV1 checkpoints (``convert_swinv1_state_dict``, JAX
``swinv1_torch_to_flax``) load into ``models/swin_v1.SwinTransformerV1`` by
key as well, with each block's ``relative_position_bias_table``
[(2S-1)², H] resampled bicubically to the model's window when the
checkpoint's differs (reference utils.py:72-90, ``F.interpolate``
bicubic, ``align_corners=False``; the JAX converter's cv2 INTER_CUBIC
branch agrees within 2e-5, its scipy fallback is another function), the
same head surgery, and the absolute position embedding of an ``ape``
model resampled as above.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

DROPPED = ("relative_position_index", "relative_coords_table", "attn_mask")


def load_map22kto1k() -> np.ndarray:
    """ImageNet-22K→1K class-index mapping (1000 row indices into the
    21841-class head), ``configs/map22kto1k.txt`` of the checkout."""
    path = os.path.join(os.path.dirname(__file__), "..", "..", "configs",
                        "map22kto1k.txt")
    with open(path) as f:
        idx = np.array([int(line.strip()) for line in f if line.strip()],
                       dtype=np.int64)
    if idx.shape[0] != 1000:
        raise ValueError(f"map22kto1k has {idx.shape[0]} entries, want 1000")
    return idx


def convert_head(head_w: np.ndarray, head_b: np.ndarray, num_classes: int):
    """(weight [classes, in], bias [classes]) of the head after the surgery."""
    n_src = head_w.shape[0]
    if n_src == num_classes:
        return head_w, head_b
    if n_src == 21841 and num_classes == 1000:
        idx = load_map22kto1k()
        return head_w[idx], head_b[idx]
    rng = np.random.RandomState(0)
    fan_in, fan_out = head_w.shape[1], num_classes
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    kernel = rng.uniform(-limit, limit, (fan_in, fan_out)).astype(np.float32)
    return kernel.T, np.zeros((fan_out,), np.float32)


def interpolate_ape(ape: torch.Tensor, dst_patches: int) -> torch.Tensor:
    """[1, S², C] → [1, D², C], bicubic on the S×S grid."""
    C = ape.shape[-1]
    S = int(round(ape.shape[1] ** 0.5))
    D = int(round(dst_patches ** 0.5))
    grid = ape.float().reshape(1, S, S, C).permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=(D, D), mode="bicubic",
                        align_corners=False)
    return out.permute(0, 2, 3, 1).reshape(1, D * D, C)


def interpolate_bias_table(table: torch.Tensor, src_window: int,
                           dst_window: int) -> torch.Tensor:
    """[(2S-1)², H] → [(2D-1)², H], bicubic on the (2S-1)×(2S-1) grid."""
    S1, S2 = 2 * src_window - 1, 2 * dst_window - 1
    H = table.shape[1]
    grid = table.float().t().reshape(1, H, S1, S1)
    out = F.interpolate(grid, size=(S2, S2), mode="bicubic",
                        align_corners=False)
    return out.reshape(H, S2 * S2).t()


def _tensors(state_dict: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors on the CPU, without the buffers the port
    rebuilds from the geometry."""
    return {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v)))
            for k, v in state_dict.items()
            if not any(s in k for s in DROPPED)}


def _with_head(out: Dict[str, torch.Tensor], sd, target, head) -> None:
    """The head after the surgery, or the model's own when the checkpoint
    has none."""
    if head is None:
        return
    if "head.weight" in sd:
        w, b = convert_head(sd["head.weight"].float().numpy(),
                            sd["head.bias"].float().numpy(),
                            head.out_features)
        out["head.weight"] = torch.as_tensor(np.ascontiguousarray(w))
        out["head.bias"] = torch.as_tensor(np.ascontiguousarray(b))
    else:
        out["head.weight"] = target["head.weight"]
        out["head.bias"] = target["head.bias"]


def _checked(out: Dict[str, torch.Tensor], target) -> Dict[str, torch.Tensor]:
    for key, t in out.items():
        if tuple(t.shape) != tuple(target[key].shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"model {tuple(target[key].shape)}")
    return {k: v.to(target[k].dtype) for k, v in out.items()}


def convert_swinv1_state_dict(state_dict: Mapping[str, object], model
                              ) -> Dict[str, torch.Tensor]:
    """The state dict ``model`` (a ``SwinTransformerV1``) loads: every
    model tensor from ``state_dict`` under its own key, each bias table
    resampled to the model's window, the head and the absolute position
    embedding as for SwinV2. Raises on a model tensor the checkpoint
    lacks."""
    sd = _tensors(state_dict)
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, t in target.items():
        if key.startswith("head."):
            continue
        if key not in sd:
            raise KeyError(f"checkpoint has no {key!r}")
        v = sd[key]
        if (key.endswith("relative_position_bias_table")
                and v.shape[0] != t.shape[0]):
            src = (int(round(v.shape[0] ** 0.5)) + 1) // 2
            dst = (int(round(t.shape[0] ** 0.5)) + 1) // 2
            v = interpolate_bias_table(v, src, dst)
        elif key == "absolute_pos_embed" and v.shape[1] != t.shape[1]:
            v = interpolate_ape(v, t.shape[1])
        out[key] = v
    _with_head(out, sd, target, model.head)
    return _checked(out, target)


def load_pretrained_swinv1(model, path: str) -> None:
    """Load a SwinV1 .pth (``{"model": state_dict}`` or a bare state dict)
    into ``model`` in place."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    model.load_state_dict(convert_swinv1_state_dict(sd, model), strict=True)


def convert_swinv2_state_dict(state_dict: Mapping[str, object], model
                              ) -> Dict[str, torch.Tensor]:
    """The state dict ``model`` (a ``SwinTransformerV2``) loads: every
    model tensor from ``state_dict`` under its own key, with the surgery
    above. Raises on a model tensor the checkpoint lacks; keys the model
    has no use for are ignored, as the JAX converter ignores them."""
    sd = _tensors(state_dict)
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, t in target.items():
        if key.startswith("head."):
            continue
        if key == "absolute_pos_embed":
            ape = sd[key]
            if ape.shape[1] != t.shape[1]:
                ape = interpolate_ape(ape, t.shape[1])
            out[key] = ape
            continue
        if key not in sd:
            raise KeyError(f"checkpoint has no {key!r}")
        out[key] = sd[key]
    _with_head(out, sd, target, model.head)
    return _checked(out, target)


def load_pretrained_swinv2(model, path: str) -> None:
    """Load a ``--pretrained`` .pth (``{"model": state_dict}`` or a bare
    state dict) into ``model`` in place."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    model.load_state_dict(convert_swinv2_state_dict(sd, model), strict=True)
