"""SwinV2 flat-layout window attention: the K1 (forward) and K2 (backward)
kernels, their plain versions, and the autograd function that joins them.

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

``window_attention_flat`` (K1), ``window_attention_flat_bwd`` (K2, the
JAX package's v2 backward ``pallas_window_attention_flat_bwd2``) and
``window_attention_flat_bwd_v1`` (K5, its v1 backward
``pallas_window_attention_flat_bwd``) run the CUDA kernels of
``csrc/window_attention_flat.cu`` for CUDA tensors and the plain versions
for CPU tensors; they never fall back from one to the other.
``flat_attention`` is the training entry. Its backward generation follows
``MVULD_ATTN_BWD`` as in the JAX package: v2 (the default) runs K1 with its
reciprocal row sums r = 1/max(Σe, 1e-30) ([Bn, H, N] fp32) in the forward
and K2 from the saved (qkv, bias, scale, out, r); v1 (``MVULD_ATTN_BWD=v1``)
saves only (qkv, bias, scale) and K5 recomputes the softmax statistics.
Neither backward replays K1.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

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


def _region_mask(qkv, ws, shift, nWh, nWw):
    return torch.as_tensor(window_region_mask(ws, shift, nWh, nWw),
                           device=qkv.device)


def _add_shift_mask(s, qkv, ws, shift, nWh, nWw):
    """s [Bn, H, N, N] + the in-window shift mask of each window."""
    if shift == 0:
        return s
    Bn, H, N, _ = s.shape
    nW = nWh * nWw
    mask = _region_mask(qkv, ws, shift, nWh, nWw)
    return (s.reshape(Bn // nW, nW, H, N, N) + mask[None, :, None]
            ).reshape(Bn, H, N, N)


def _heads(x, Bn, N, H, hd):
    """[Bn, N, H·hd] → [Bn, H, N, hd] fp32."""
    return x.reshape(Bn, N, H, hd).permute(0, 2, 1, 3).float()


def _normalised_qkv(qkv, Bn, N, H, hd):
    x = qkv.reshape(Bn, N, 3, H, hd).permute(2, 0, 3, 1, 4).float()
    q, k, v = x[0], x[1], x[2]                             # [Bn, H, N, hd]
    qn = torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    kn = torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    return q * qn, k * kn, v, qn, kn


def window_attention_flat_plain(qkv, bias, logit_scale, shift: int = 0,
                                nWh: int = 1, nWw: int = 1,
                                return_rowsum: bool = False):
    """Plain PyTorch version of the K1 kernel (same math, same layout);
    with ``return_rowsum`` also the reciprocal row sums [Bn, H, N] fp32."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    q, k, v, _, _ = _normalised_qkv(qkv, Bn, N, H, C // H)
    scale, m = shift_and_scale(logit_scale, bias)
    s = (q @ k.transpose(-1, -2)) * scale[:, None, None] + bias.float()
    s = _add_shift_mask(s, qkv, ws, shift, nWh, nWw)
    e = torch.exp(s - m[:, None, None])
    denom = e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = ((e @ v) / denom).permute(0, 2, 1, 3).reshape(Bn, N, C)
    out = out.to(qkv.dtype)
    return (out, 1.0 / denom[..., 0]) if return_rowsum else out


def window_attention_flat_bwd_plain(qkv, bias, logit_scale, o, r, g,
                                    shift: int = 0, nWh: int = 1,
                                    nWw: int = 1):
    """Plain PyTorch version of K2 (``_flat_bwd2_body``): from the forward
    output ``o`` and row sums ``r``, returns (dqkv [Bn, N, 3C] in qkv's
    dtype, dbias [H, N, N] fp32, dscale [H] fp32)."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    hd = C // H
    qh, kh, v, qn, kn = _normalised_qkv(qkv, Bn, N, H, hd)
    scale, m = shift_and_scale(logit_scale, bias)
    gh, oh = _heads(g, Bn, N, H, hd), _heads(o, Bn, N, H, hd)
    s = (qh @ kh.transpose(-1, -2)) * scale[:, None, None] + bias.float()
    s = s + (torch.log(r.float()) - m[:, None])[..., None]
    p = torch.exp(_add_shift_mask(s, qkv, ws, shift, nWh, nWw))
    t = (gh * oh).sum(-1, keepdim=True)
    ds = p * (gh @ v.transpose(-1, -2) - t)
    dqh = (ds @ kh) * scale[:, None, None]
    rowq = (qh * dqh).sum(-1, keepdim=True)
    dkh = (ds.transpose(-1, -2) @ qh) * scale[:, None, None]
    dv = p.transpose(-1, -2) @ gh
    dq = (dqh - qh * rowq) * qn
    dk = (dkh - kh * (kh * dkh).sum(-1, keepdim=True)) * kn
    dqkv = torch.stack([dq, dk, dv], 2)                    # [Bn, H, 3, N, hd]
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(Bn, N, 3 * C).to(qkv.dtype)
    return dqkv, ds.sum(0), rowq.sum((0, 2, 3)) / scale


def window_attention_flat_bwd_v1_plain(qkv, bias, logit_scale, g,
                                       shift: int = 0, nWh: int = 1,
                                       nWw: int = 1):
    """Plain PyTorch version of K5 (``_flat_bwd_kernel_factory``): from the
    forward's inputs alone, returns (dqkv [Bn, N, 3C] in qkv's dtype,
    dbias [H, N, N] fp32, dscale [H] fp32). The softmax is recomputed as
    e = exp(s − m) with r = 1/max(Σe, 1e-30) and t = Σ dp·e, and
    ds = e·(r·(dp − r·t)) in that order: r may reach 1e30, and r² would
    overflow fp32."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    hd = C // H
    qh, kh, v, qn, kn = _normalised_qkv(qkv, Bn, N, H, hd)
    scale, m = shift_and_scale(logit_scale, bias)
    gh = _heads(g, Bn, N, H, hd)
    s_cos = qh @ kh.transpose(-1, -2)
    s = s_cos * scale[:, None, None] + (bias.float() - m[:, None, None])
    e = torch.exp(_add_shift_mask(s, qkv, ws, shift, nWh, nWw))
    r = 1.0 / e.sum(-1, keepdim=True).clamp_min(1e-30)
    dp = gh @ v.transpose(-1, -2)
    t = (dp * e).sum(-1, keepdim=True)
    ds = e * (r * (dp - r * t))
    dqh = (ds @ kh) * scale[:, None, None]
    dkh = (ds.transpose(-1, -2) @ qh) * scale[:, None, None]
    dv = e.transpose(-1, -2) @ (r * gh)
    dq = (dqh - qh * (qh * dqh).sum(-1, keepdim=True)) * qn
    dk = (dkh - kh * (kh * dkh).sum(-1, keepdim=True)) * kn
    dqkv = torch.stack([dq, dk, dv], 2)                    # [Bn, H, 3, N, hd]
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(Bn, N, 3 * C).to(qkv.dtype)
    return dqkv, ds.sum(0), (ds * s_cos).sum((0, 2, 3))


_N_PTRS = {"window_attention_flat_fwd": 6, "window_attention_flat_bwd": 11,
           "window_attention_flat_bwd_v1": 11}


def _lib(name):
    lib = _build.load("window_attention_flat")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * _N_PTRS[name]
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(qkv, Bn, C, H, what):
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qkv.device}")
    if C // H != _HEAD_DIM:
        raise ValueError(f"{what} kernel: head dim {C // H} "
                         f"(want {_HEAD_DIM})")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} kernel: qkv dtype {qkv.dtype} "
                         f"(want bfloat16 or float32)")
    if Bn > 65535:                       # the grid's z dimension
        raise ValueError(f"{what} kernel: {Bn} windows "
                         f"(at most 65535 per launch)")


def _kernel_scalars(qkv, bias, logit_scale):
    bias = bias.to(device=qkv.device, dtype=torch.float32).contiguous()
    scale, m = shift_and_scale(logit_scale.to(qkv.device), bias)
    return bias, scale.contiguous(), m.contiguous()


def window_attention_flat(qkv, bias, logit_scale, shift: int = 0,
                          nWh: int = 1, nWw: int = 1,
                          return_rowsum: bool = False):
    """Flat-layout fused window attention forward (K1).

    CUDA tensors run ``csrc/window_attention_flat.cu`` (qkv in bf16 or fp32,
    head dim 32; anything else raises); CPU tensors run
    ``window_attention_flat_plain``. With ``return_rowsum`` also returns
    the reciprocal row sums [Bn, H, N] fp32."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    if qkv.device.type == "cpu":
        return window_attention_flat_plain(qkv, bias, logit_scale, shift,
                                           nWh, nWw, return_rowsum)
    _check_cuda(qkv, Bn, C, H, "window_attention_flat")
    qkv = qkv.contiguous()
    bias, scale, m = _kernel_scalars(qkv, bias, logit_scale)
    out = torch.empty((Bn, N, C), dtype=qkv.dtype, device=qkv.device)
    r = (torch.empty((Bn, H, N), dtype=torch.float32, device=qkv.device)
         if return_rowsum else None)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _lib("window_attention_flat_fwd")(
        qkv.data_ptr(), bias.data_ptr(), scale.data_ptr(), m.data_ptr(),
        out.data_ptr(), 0 if r is None else r.data_ptr(),
        int(qkv.dtype == torch.bfloat16), Bn, N, C, H, ws, int(shift),
        int(nWh), int(nWw), stream)
    window_attention_flat.launches += 1
    _build.check(err, "window_attention_flat")
    return (out, r) if return_rowsum else out


def window_attention_flat_bwd(qkv, bias, logit_scale, o, r, g,
                              shift: int = 0, nWh: int = 1, nWw: int = 1):
    """Flat-layout window attention backward (K2): (dqkv [Bn, N, 3C] in
    qkv's dtype, dbias [H, N, N] fp32, dscale [H] fp32) from the forward's
    output ``o`` and row sums ``r`` and the output gradient ``g``.

    CUDA tensors run the three kernels of ``csrc/window_attention_flat.cu``
    (dq, dk/dv, dbias + dscale); CPU tensors run
    ``window_attention_flat_bwd_plain``."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    if tuple(o.shape) != (Bn, N, C) or tuple(g.shape) != (Bn, N, C) \
            or tuple(r.shape) != (Bn, H, N):
        raise ValueError(f"window_attention_flat_bwd: o {tuple(o.shape)}, "
                         f"g {tuple(g.shape)}, r {tuple(r.shape)} do not fit "
                         f"[Bn={Bn}, N={N}, C={C}], H={H}")
    if qkv.device.type == "cpu":
        return window_attention_flat_bwd_plain(qkv, bias, logit_scale, o, r,
                                               g, shift, nWh, nWw)
    _check_cuda(qkv, Bn, C, H, "window_attention_flat_bwd")
    dev, dt = qkv.device, qkv.dtype
    qkv = qkv.contiguous()
    o, g = o.to(dt).contiguous(), g.to(dt).contiguous()
    r = r.to(torch.float32).contiguous()
    bias, scale, m = _kernel_scalars(qkv, bias, logit_scale)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((H, N, N), dtype=torch.float32, device=dev)
    dscale = torch.empty((H,), dtype=torch.float32, device=dev)
    part = torch.empty((Bn * H * -(-N // 64),), dtype=torch.float32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib("window_attention_flat_bwd")(
        qkv.data_ptr(), bias.data_ptr(), scale.data_ptr(), m.data_ptr(),
        o.data_ptr(), r.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        dbias.data_ptr(), dscale.data_ptr(), part.data_ptr(),
        int(dt == torch.bfloat16), Bn, N, C, H, ws, int(shift), int(nWh),
        int(nWw), stream)
    window_attention_flat_bwd.launches += 1
    _build.check(err, "window_attention_flat_bwd")
    return dqkv, dbias, dscale


def window_attention_flat_bwd_v1(qkv, bias, logit_scale, g, shift: int = 0,
                                 nWh: int = 1, nWw: int = 1):
    """Flat-layout window attention v1 backward (K5): (dqkv [Bn, N, 3C] in
    qkv's dtype, dbias [H, N, N] fp32, dscale [H] fp32) from the forward's
    inputs and the output gradient ``g`` alone.

    CUDA tensors run ``bwd_rowstats`` and then K2's three kernels of
    ``csrc/window_attention_flat.cu`` on its row statistics; CPU tensors
    run ``window_attention_flat_bwd_v1_plain``."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    if tuple(g.shape) != (Bn, N, C):
        raise ValueError(f"window_attention_flat_bwd_v1: g {tuple(g.shape)} "
                         f"does not fit [Bn={Bn}, N={N}, C={C}]")
    if qkv.device.type == "cpu":
        return window_attention_flat_bwd_v1_plain(qkv, bias, logit_scale, g,
                                                  shift, nWh, nWw)
    _check_cuda(qkv, Bn, C, H, "window_attention_flat_bwd_v1")
    dev, dt = qkv.device, qkv.dtype
    qkv, g = qkv.contiguous(), g.to(dt).contiguous()
    bias, scale, m = _kernel_scalars(qkv, bias, logit_scale)
    f32 = dict(dtype=torch.float32, device=dev)
    dqkv = torch.empty_like(qkv)
    dbias, dscale = torch.empty((H, N, N), **f32), torch.empty((H,), **f32)
    part = torch.empty((Bn * H * -(-N // 64),), **f32)
    rsum, tsum = torch.empty((Bn, H, N), **f32), torch.empty((Bn, H, N), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib("window_attention_flat_bwd_v1")(
        qkv.data_ptr(), bias.data_ptr(), scale.data_ptr(), m.data_ptr(),
        g.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(), dscale.data_ptr(),
        part.data_ptr(), rsum.data_ptr(), tsum.data_ptr(),
        int(dt == torch.bfloat16), Bn, N, C, H, ws, int(shift), int(nWh),
        int(nWw), stream)
    window_attention_flat_bwd_v1.launches += 1
    _build.check(err, "window_attention_flat_bwd_v1")
    return dqkv, dbias, dscale


window_attention_flat.launches = 0
window_attention_flat_bwd.launches = 0
window_attention_flat_bwd_v1.launches = 0


def _flat_bwd_v2_default() -> bool:
    """v2 backward unless ``MVULD_ATTN_BWD=v1`` (the JAX package's switch)."""
    return os.environ.get("MVULD_ATTN_BWD", "v2").lower() != "v1"


class _FlatAttention(torch.autograd.Function):
    """K1 forward with row sums; K2 backward from the saved residuals. The
    logit scale enters as the already exp-clamped per-head scale [H]."""

    @staticmethod
    def forward(ctx, qkv, bias, scale, shift, nWh, nWw, saved):
        if saved is None:
            out, r = window_attention_flat(qkv, bias, scale, shift, nWh, nWw,
                                           return_rowsum=True)
        else:
            out, r = saved[0].detach(), saved[1].detach()
        ctx.geom = (shift, nWh, nWw)
        ctx.save_for_backward(qkv, bias, scale, out, r)
        ctx.mark_non_differentiable(r)
        return out, r

    @staticmethod
    def backward(ctx, g, _g_r):
        qkv, bias, scale, out, r = ctx.saved_tensors
        dqkv, dbias, dscale = window_attention_flat_bwd(
            qkv, bias, scale, out, r, g, *ctx.geom)
        return (dqkv, dbias.to(bias.dtype), dscale.to(scale.dtype),
                None, None, None, None)


class _FlatAttentionV1(torch.autograd.Function):
    """K1 forward; K5 backward from (qkv, bias, scale) alone, as the JAX v1
    VJP saves only the kernel's inputs."""

    @staticmethod
    def forward(ctx, qkv, bias, scale, shift, nWh, nWw, saved):
        out = (window_attention_flat(qkv, bias, scale, shift, nWh, nWw)
               if saved is None else saved[0].detach())
        ctx.geom = (shift, nWh, nWw)
        ctx.save_for_backward(qkv, bias, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, bias, scale = ctx.saved_tensors
        dqkv, dbias, dscale = window_attention_flat_bwd_v1(
            qkv, bias, scale, g, *ctx.geom)
        return (dqkv, dbias.to(bias.dtype), dscale.to(scale.dtype),
                None, None, None, None)


def flat_attention(qkv, bias, scale, shift: int = 0, nWh: int = 1,
                   nWw: int = 1, saved=None, bwd_v2: Optional[bool] = None):
    """Differentiable flat window attention: K1 forward, K2 (``bwd_v2``,
    the default unless ``MVULD_ATTN_BWD=v1``) or K5 backward.

    Returns (out, r), r the row sums under v2 and None under v1.
    ``saved``, a previous call's (out, r) on the same inputs, skips K1:
    under activation checkpointing the recomputed forward reuses the first
    forward's output (and row sums), as the JAX remat policy saves
    ``attn_out`` / ``attn_rowsum``."""
    if bwd_v2 is None:
        bwd_v2 = _flat_bwd_v2_default()
    if bwd_v2:
        return _FlatAttention.apply(qkv, bias, scale, shift, nWh, nWw, saved)
    return (_FlatAttentionV1.apply(qkv, bias, scale, shift, nWh, nWw, saved),
            None)
