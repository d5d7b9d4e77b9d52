"""SwinV2 flat-layout window attention: the K1 kernel and its plain version.

Counterpart of ``mvuld_tpu/ops/window_attention.py``
``window_attention_flat`` / ``pallas_window_attention_flat``. The layout is
the JAX one: qkv ``[Bn, N, 3C]`` with batch-major windows
(b = image·nW + wh·nWw + ww), bias ``[H, N, N]`` fp32, per-head logit scale
``[H]``; the output is ``[Bn, N, C]`` in qkv's dtype.

The numerics are the Pallas kernel's, not the XLA branch's of
``models/swin_v2.py``: q and k are multiplied by rsqrt(Σx² + 1e-12), the
softmax subtracts a fixed per-head shift m_h = scale_h + max(bias[h]) in
place of the row max (cosine ≤ 1 and the mask ≤ 0 bound every logit by m_h,
so exp cannot overflow), the row sum is clamped at 1e-30 so a row that
underflows saturates instead of dividing 0 by 0, and the shift mask is
derived from the window id: two tokens of a window in the last window row
or column of the rolled map attend only when they share a shift region,
−100 otherwise.

``window_attention_flat`` runs the CUDA kernel of
``csrc/window_attention_flat.cu`` for CUDA tensors and the plain version
for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from mvuld_tpu_torch.ops import _build

_HEAD_DIM = 32   # SwinV2's head dim; the kernel is instantiated for it


def _check_flat_geometry(Bn, N, C, H, ws, bias_shape, shift, nWh, nWw):
    """Input validation for the flat entry points: a non-square N, a
    mismatched bias, or a shift without the window grid would silently
    compute attention over truncated windows / wrong boundary masks."""
    if ws * ws != N:
        raise ValueError(f"flat window attention: N={N} is not a square "
                         f"(ws²); got qkv shape [*, {N}, {3*C}]")
    if C % H != 0:
        raise ValueError(f"flat window attention: C={C} not divisible by "
                         f"H={H} heads")
    if tuple(bias_shape) != (H, N, N):
        raise ValueError(f"flat window attention: bias shape "
                         f"{tuple(bias_shape)} != (H={H}, N={N}, N={N})")
    if shift > 0:
        if nWh < 2 or nWw < 2:
            raise ValueError(
                f"flat window attention: shift={shift} requires the window "
                f"grid (nWh, nWw) ≥ 2 — with the default (1, 1) every "
                f"window would get the boundary mask (wrong results)")
        if Bn % (nWh * nWw) != 0:
            raise ValueError(f"flat window attention: Bn={Bn} not a "
                             f"multiple of nWh·nWw={nWh*nWw}")


def _geometry(qkv, bias, logit_scale, shift, nWh, nWw):
    Bn, N, threeC = qkv.shape
    C = threeC // 3
    H = bias.shape[0]
    ws = math.isqrt(N)
    _check_flat_geometry(Bn, N, C, H, ws, bias.shape, shift, nWh, nWw)
    if logit_scale.numel() != H:
        raise ValueError(f"flat window attention: {logit_scale.numel()} "
                         f"logit scales for H={H} heads")
    return Bn, N, C, H, ws


def window_region_mask(ws: int, shift: int, nWh: int, nWw: int) -> np.ndarray:
    """The kernel's in-window shift mask for every window of one image,
    [nW, N, N] fp32 (0 or −100). Equals ``shifted_window_mask`` of
    ``models/swin_v2.py`` on the rolled map."""
    N = ws * ws
    idx = np.arange(N)
    r, c = idx // ws, idx % ws
    masks = np.zeros((nWh * nWw, N, N), np.float32)
    for wid in range(nWh * nWw):
        last_i = wid // nWw == nWh - 1
        last_j = wid % nWw == nWw - 1
        region = (3 * (last_i & (r >= ws - shift)).astype(np.int32)
                  + (last_j & (c >= ws - shift)).astype(np.int32))
        masks[wid] = np.where(region[:, None] != region[None, :], -100.0, 0.0)
    return masks


def shift_and_scale(logit_scale, bias):
    """Per-head scale [H] and the fixed softmax shift m = scale + max(bias)."""
    scale = logit_scale.reshape(-1).float()
    return scale, scale + bias.float().amax(dim=(1, 2))


def window_attention_flat_plain(qkv, bias, logit_scale, shift: int = 0,
                                nWh: int = 1, nWw: int = 1):
    """Plain PyTorch version of the K1 kernel (same math, same layout)."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    hd = C // H
    x = qkv.reshape(Bn, N, 3, H, hd).permute(2, 0, 3, 1, 4).float()
    q, k, v = x[0], x[1], x[2]                             # [Bn, H, N, hd]
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    scale, m = shift_and_scale(logit_scale, bias)
    s = (q @ k.transpose(-1, -2)) * scale[:, None, None] + bias.float()
    if shift > 0:
        nW = nWh * nWw
        mask = torch.as_tensor(window_region_mask(ws, shift, nWh, nWw),
                               device=qkv.device)
        s = (s.reshape(Bn // nW, nW, H, N, N) + mask[None, :, None]
             ).reshape(Bn, H, N, N)
    e = torch.exp(s - m[:, None, None])
    out = (e @ v) / e.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).reshape(Bn, N, C).to(qkv.dtype)


def _lib():
    lib = _build.load("window_attention_flat")
    fn = lib.window_attention_flat_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def window_attention_flat(qkv, bias, logit_scale, shift: int = 0,
                          nWh: int = 1, nWw: int = 1):
    """Flat-layout fused window attention forward (K1).

    CUDA tensors run ``csrc/window_attention_flat.cu`` (qkv in bf16 or fp32,
    head dim 32; anything else raises); CPU tensors run
    ``window_attention_flat_plain``."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    if qkv.device.type == "cpu":
        return window_attention_flat_plain(qkv, bias, logit_scale, shift,
                                           nWh, nWw)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_flat: unsupported device "
                         f"{qkv.device}")
    hd = C // H
    if hd != _HEAD_DIM:
        raise ValueError(f"window_attention_flat kernel: head dim {hd} "
                         f"(want {_HEAD_DIM})")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"window_attention_flat kernel: qkv dtype "
                         f"{qkv.dtype} (want bfloat16 or float32)")
    if Bn > 65535:                       # the grid's z dimension
        raise ValueError(f"window_attention_flat kernel: {Bn} windows "
                         f"(at most 65535 per launch)")
    qkv = qkv.contiguous()
    bias = bias.to(device=qkv.device, dtype=torch.float32).contiguous()
    scale, m = shift_and_scale(logit_scale.to(qkv.device), bias)
    scale, m = scale.contiguous(), m.contiguous()
    out = torch.empty((Bn, N, C), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _lib()(qkv.data_ptr(), bias.data_ptr(), scale.data_ptr(),
                 m.data_ptr(), out.data_ptr(),
                 int(qkv.dtype == torch.bfloat16), Bn, N, C, H, ws,
                 int(shift), int(nWh), int(nWw), stream)
    window_attention_flat.launches += 1
    _build.check(err, "window_attention_flat")
    return out


window_attention_flat.launches = 0
