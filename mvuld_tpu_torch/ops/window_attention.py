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

The other two layouts of the JAX module are here too, with the exact
softmax (the row maximum is subtracted, no fixed shift) that its kernels
compute: the head layout ``window_attention`` (q, k, v ``[Bn, H, N, hd]``
and an optional ``[nW, N, N]`` mask operand, window b reading
``mask[b % nW]``; kernels K8 ``window_attention_fwd`` and K8b
``window_attention_bwd``) and the map layout ``window_attention_map`` (qkv
``[B, Hp, Wp, 3, H, hd]`` read in place from the already rolled feature
map, the shift mask synthesised from the window's grid position, fp32
output ``[B, Hp, Wp, H, hd]`` and fp32 dqkv whatever qkv's dtype; kernels K7
``window_attention_map_fwd`` and K7b ``window_attention_map_bwd``). All four
run ``csrc/window_attention.cu`` for CUDA tensors and the ``*_plain``
versions for CPU tensors. The JAX module's mask registry
(``register_mask`` / ``make_window_attention``) exists only to give
``custom_vjp`` a static argument; here the mask is a plain
non-differentiable argument of the autograd function.
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


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_GEO = ctypes.POINTER(ctypes.c_int)
# C entry → (source under csrc/, argument types)
_ENTRIES = {
    "window_attention_flat_fwd": ("window_attention_flat",
                                  [_PTR] * 6 + [_INT] * 9 + [_PTR]),
    "window_attention_flat_bwd": ("window_attention_flat",
                                  [_PTR] * 11 + [_INT] * 9 + [_PTR]),
    "window_attention_flat_bwd_v1": ("window_attention_flat",
                                     [_PTR] * 11 + [_INT] * 9 + [_PTR]),
    "window_attention_fwd": ("window_attention",
                             [_PTR] * 7 + [_INT] * 3 + [_GEO, _PTR]),
    "window_attention_bwd": ("window_attention",
                             [_PTR] * 15 + [_INT] * 3 + [_GEO, _PTR]),
}


def _lib(name):
    source, argtypes = _ENTRIES[name]
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(x, Bn, hd, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if hd != _HEAD_DIM:
        raise ValueError(f"{what} kernel: head dim {hd} (want {_HEAD_DIM})")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} kernel: dtype {x.dtype} (want bfloat16 or "
                         f"float32)")
    if Bn > 65535:                       # the grid's z dimension
        raise ValueError(f"{what} kernel: {Bn} windows (at most 65535 per "
                         f"launch)")


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
    _check_cuda(qkv, Bn, C // H, "window_attention_flat")
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
    _check_cuda(qkv, Bn, C // H, "window_attention_flat_bwd")
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
    _check_cuda(qkv, Bn, C // H, "window_attention_flat_bwd_v1")
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


# --------------------------------------------------------------------------- #
# head layout (K8 / K8b) and map layout (K7 / K7b): exact softmax
# --------------------------------------------------------------------------- #


def _mxu_bf16_default(mxu_bf16: bool) -> bool:
    """``MVULD_ATTN_MXU_BF16=1`` rounds the map kernels' product operands to
    bf16 (the JAX package's switch)."""
    return bool(mxu_bf16) or os.environ.get("MVULD_ATTN_MXU_BF16", "0") == "1"


def _r16(x, on: bool):
    """x rounded to bf16 and back, when ``on``."""
    return x.to(torch.bfloat16).float() if on else x


def _mask_tensor(mask, device):
    if mask is None:
        return None
    return torch.as_tensor(mask, dtype=torch.float32, device=device)


def _head_geometry(q, k, v, bias, logit_scale, mask, what):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must share one [Bn, H, N, hd]")
    Bn, H, N, hd = q.shape
    if tuple(bias.shape) != (H, N, N):
        raise ValueError(f"{what}: bias shape {tuple(bias.shape)} != "
                         f"(H={H}, N={N}, N={N})")
    if logit_scale.numel() != H:
        raise ValueError(f"{what}: {logit_scale.numel()} logit scales for "
                         f"H={H} heads")
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (N, N):
            raise ValueError(f"{what}: mask shape {tuple(mask.shape)} != "
                             f"(nW, N={N}, N={N})")
        if Bn % mask.shape[0] != 0:
            raise ValueError(f"{what}: Bn={Bn} windows (q {tuple(q.shape)}) "
                             f"not a multiple of the mask's nW="
                             f"{mask.shape[0]} (mask {tuple(mask.shape)})")
    return Bn, H, N, hd


def _map_geometry(qkv, bias, logit_scale, what):
    if qkv.dim() != 6 or qkv.shape[3] != 3:
        raise ValueError(f"{what}: qkv shape {tuple(qkv.shape)} is not "
                         f"[B, Hp, Wp, 3, H, hd]")
    B, Hp, Wp, _, H, hd = qkv.shape
    N = bias.shape[-1]
    ws = math.isqrt(N)
    if ws * ws != N or tuple(bias.shape) != (H, N, N):
        raise ValueError(f"{what}: bias shape {tuple(bias.shape)} != "
                         f"(H={H}, ws², ws²)")
    if Hp % ws or Wp % ws:
        raise ValueError(f"{what}: map {Hp}×{Wp} (qkv {tuple(qkv.shape)}) is "
                         f"not a whole number of {ws}×{ws} windows")
    if logit_scale.numel() != H:
        raise ValueError(f"{what}: {logit_scale.numel()} logit scales for "
                         f"H={H} heads")
    return B, Hp, Wp, H, hd, ws, N


def _add_mask(s, mask):
    """s [Bn, H, N, N] + mask[b % nW] for window b."""
    if mask is None:
        return s
    Bn, H, N, _ = s.shape
    nW = mask.shape[0]
    return (s.reshape(Bn // nW, nW, H, N, N) + mask[None, :, None]
            ).reshape(Bn, H, N, N)


def _core_fwd(q, k, v, bias, scale, mask, round_ops, round_p):
    """Attention of fp32 q, k, v [Bn, H, N, hd] → fp32 [Bn, H, N, hd]."""
    qh = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    kh = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    s = _r16(qh, round_ops) @ _r16(kh, round_ops).transpose(-1, -2)
    s = _add_mask(s * scale[:, None, None] + bias.float(), mask)
    p = torch.softmax(s, dim=-1)
    return _r16(p, round_p) @ _r16(v, round_ops)


def _core_bwd(q, k, v, bias, scale, mask, g, round_ops, round_p):
    """The kernels' backward written out (the body of the Pallas backward
    kernels, not autograd through the forward): fp32 (dq, dk, dv
    [Bn, H, N, hd], dbias [H, N, N], dscale [H])."""
    qn = torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    kn = torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    qh, kh = q * qn, k * kn
    q16, k16 = _r16(qh, round_ops), _r16(kh, round_ops)
    v16, g16 = _r16(v, round_ops), _r16(g, round_ops)
    sc = scale[:, None, None]
    s_cos = q16 @ k16.transpose(-1, -2)
    p = torch.softmax(_add_mask(s_cos * sc + bias.float(), mask), dim=-1)
    dp = g16 @ v16.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dbias, dscale = ds.sum(0), (ds * s_cos).sum((0, 2, 3))
    ds16 = _r16(ds, round_ops)
    dv = _r16(p, round_p).transpose(-1, -2) @ g16
    dqh = (ds16 @ k16) * sc
    dkh = (ds16.transpose(-1, -2) @ q16) * sc
    dq = (dqh - qh * (qh * dqh).sum(-1, keepdim=True)) * qn
    dk = (dkh - kh * (kh * dkh).sum(-1, keepdim=True)) * kn
    return dq, dk, dv, dbias, dscale


def window_attention_plain(q, k, v, bias, logit_scale, mask=None):
    """Plain PyTorch version of K8 (``window_attention_reference`` with the
    kernel's rsqrt normalisation): q, k, v [Bn, H, N, hd] → [Bn, H, N, hd] in
    q's dtype; p is rounded to v's dtype before p·v, as the kernel does."""
    mask = _mask_tensor(mask, q.device)
    _head_geometry(q, k, v, bias, logit_scale, mask, "window_attention")
    out = _core_fwd(q.float(), k.float(), v.float(), bias,
                    logit_scale.reshape(-1).float(), mask, False,
                    v.dtype == torch.bfloat16)
    return out.to(q.dtype)


def window_attention_bwd_plain(q, k, v, bias, logit_scale, g, mask=None):
    """Plain PyTorch version of K8b: (dq, dk, dv in the inputs' dtypes, dbias
    [H, N, N] fp32, dscale [H] fp32), all in fp32 arithmetic."""
    mask = _mask_tensor(mask, q.device)
    _head_geometry(q, k, v, bias, logit_scale, mask, "window_attention_bwd")
    dq, dk, dv, dbias, dscale = _core_bwd(
        q.float(), k.float(), v.float(), bias,
        logit_scale.reshape(-1).float(), mask, g.float(), False, False)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias, dscale


def _map_to_windows(qkv, ws):
    """[B, Hp, Wp, 3, H, hd] → fp32 q, k, v [Bn, H, N, hd], b = image·nW +
    window row·nWw + window column."""
    B, Hp, Wp, _, H, hd = qkv.shape
    x = qkv.reshape(B, Hp // ws, ws, Wp // ws, ws, 3, H, hd)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, H, ws * ws, hd)
    return x[0].float(), x[1].float(), x[2].float()


def _heads_map_to_windows(g, ws):
    """[B, Hp, Wp, H, hd] → fp32 [Bn, H, N, hd]."""
    B, Hp, Wp, H, hd = g.shape
    x = g.reshape(B, Hp // ws, ws, Wp // ws, ws, H, hd)
    return x.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, H, ws * ws, hd).float()


def _windows_to_map(o, B, Hp, Wp, ws):
    """[..., Bn, H, N, hd] → [B, Hp, Wp, ..., H, hd]."""
    lead = o.shape[:-4]
    H, hd = o.shape[-3], o.shape[-1]
    x = o.reshape(*lead, B, Hp // ws, Wp // ws, H, ws, ws, hd)
    n = len(lead)
    perm = [n, n + 1, n + 4, n + 2, n + 5, *range(n), n + 3, n + 6]
    return x.permute(perm).reshape(B, Hp, Wp, *lead, H, hd)


def _map_mask(qkv, ws, shift, Hp, Wp):
    if shift == 0:
        return None
    return torch.as_tensor(window_region_mask(ws, shift, Hp // ws, Wp // ws),
                           device=qkv.device)


def window_attention_map_plain(qkv, bias, logit_scale, shift: int = 0,
                               mxu_bf16: bool = False):
    """Plain PyTorch version of K7: qkv [B, Hp, Wp, 3, H, hd] (already
    rolled for ``shift`` > 0) → fp32 [B, Hp, Wp, H, hd]."""
    B, Hp, Wp, H, hd, ws, N = _map_geometry(qkv, bias, logit_scale,
                                            "window_attention_map")
    r = _mxu_bf16_default(mxu_bf16)
    q, k, v = _map_to_windows(qkv, ws)
    out = _core_fwd(q, k, v, bias, logit_scale.reshape(-1).float(),
                    _map_mask(qkv, ws, shift, Hp, Wp), r, r)
    return _windows_to_map(out, B, Hp, Wp, ws)


def window_attention_map_bwd_plain(qkv, bias, logit_scale, g, shift: int = 0,
                                   mxu_bf16: bool = False):
    """Plain PyTorch version of K7b: (dqkv fp32 [B, Hp, Wp, 3, H, hd], dbias
    [H, N, N] fp32, dscale [H] fp32)."""
    B, Hp, Wp, H, hd, ws, N = _map_geometry(qkv, bias, logit_scale,
                                            "window_attention_map_bwd")
    r = _mxu_bf16_default(mxu_bf16)
    q, k, v = _map_to_windows(qkv, ws)
    dq, dk, dv, dbias, dscale = _core_bwd(
        q, k, v, bias, logit_scale.reshape(-1).float(),
        _map_mask(qkv, ws, shift, Hp, Wp), _heads_map_to_windows(g, ws), r, r)
    dqkv = _windows_to_map(torch.stack([dq, dk, dv]), B, Hp, Wp, ws)
    return dqkv, dbias, dscale


def _geo(N, H, ws=0, shift=0, nWh=0, nWw=0, nWmask=0, round_ops=False,
         round_p=False, is_map=False, Hp=0, Wp=0):
    return (ctypes.c_int * 12)(N, H, ws, int(shift), nWh, nWw, nWmask,
                               int(round_ops), int(round_p), int(is_map),
                               Hp, Wp)


def _f32(x, dev):
    return x.to(device=dev, dtype=torch.float32).contiguous()


def window_attention_fwd(q, k, v, bias, logit_scale, mask=None):
    """Head-layout window attention forward (K8): q, k, v [Bn, H, N, hd],
    bias [H, N, N], logit_scale [H], mask [nW, N, N] or None → [Bn, H, N,
    hd] in q's dtype. CUDA tensors run ``csrc/window_attention.cu`` (bf16 or
    fp32, head dim 32; anything else raises); CPU tensors run
    ``window_attention_plain``."""
    mask = _mask_tensor(mask, q.device)
    Bn, H, N, hd = _head_geometry(q, k, v, bias, logit_scale, mask,
                                  "window_attention")
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, logit_scale, mask)
    _check_cuda(q, Bn, hd, "window_attention")
    dev, dt = q.device, q.dtype
    q, k, v = q.contiguous(), k.to(dt).contiguous(), v.to(dt).contiguous()
    bias, scale = _f32(bias, dev), _f32(logit_scale.reshape(-1), dev)
    mask = None if mask is None else mask.contiguous()
    out = torch.empty_like(q)
    bf = int(dt == torch.bfloat16)
    err = _lib("window_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        scale.data_ptr(), 0 if mask is None else mask.data_ptr(),
        out.data_ptr(), bf, bf, Bn,
        _geo(N, H, nWmask=0 if mask is None else mask.shape[0], round_p=bf),
        torch.cuda.current_stream(dev).cuda_stream)
    window_attention_fwd.launches += 1
    _build.check(err, "window_attention_fwd")
    return out


def window_attention_bwd(q, k, v, bias, logit_scale, g, mask=None):
    """Head-layout window attention backward (K8b), from the forward's
    inputs alone: (dq, dk, dv in the inputs' dtype, dbias [H, N, N] fp32,
    dscale [H] fp32). CUDA tensors run the kernels of
    ``csrc/window_attention.cu`` (row statistics, dq, dk/dv, dbias + dscale);
    CPU tensors run ``window_attention_bwd_plain``."""
    mask = _mask_tensor(mask, q.device)
    Bn, H, N, hd = _head_geometry(q, k, v, bias, logit_scale, mask,
                                  "window_attention_bwd")
    if g.shape != q.shape:
        raise ValueError(f"window_attention_bwd: g {tuple(g.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return window_attention_bwd_plain(q, k, v, bias, logit_scale, g, mask)
    _check_cuda(q, Bn, hd, "window_attention_bwd")
    dev, dt = q.device, q.dtype
    q, k, v, g = (t.to(dt).contiguous() for t in (q, k, v, g))
    bias, scale = _f32(bias, dev), _f32(logit_scale.reshape(-1), dev)
    mask = None if mask is None else mask.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=dev)
    dbias, dscale = torch.empty((H, N, N), **f32), torch.empty((H,), **f32)
    lr, tt = torch.empty((Bn, H, N), **f32), torch.empty((Bn, H, N), **f32)
    part = torch.empty(((-(-N // 64)) ** 2 * H,), **f32)
    bf = int(dt == torch.bfloat16)
    err = _lib("window_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        scale.data_ptr(), 0 if mask is None else mask.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbias.data_ptr(), dscale.data_ptr(), lr.data_ptr(), tt.data_ptr(),
        part.data_ptr(), bf, bf, Bn,
        _geo(N, H, nWmask=0 if mask is None else mask.shape[0]),
        torch.cuda.current_stream(dev).cuda_stream)
    window_attention_bwd.launches += 1
    _build.check(err, "window_attention_bwd")
    return dq, dk, dv, dbias, dscale


def window_attention_map_fwd(qkv, bias, logit_scale, shift: int = 0,
                             mxu_bf16: bool = False):
    """Map-layout window attention forward (K7): qkv [B, Hp, Wp, 3, H, hd]
    as the projection writes it (already rolled for ``shift`` > 0), read in
    place → fp32 [B, Hp, Wp, H, hd]. CUDA tensors run
    ``csrc/window_attention.cu``; CPU tensors ``window_attention_map_plain``."""
    B, Hp, Wp, H, hd, ws, N = _map_geometry(qkv, bias, logit_scale,
                                            "window_attention_map")
    if qkv.device.type == "cpu":
        return window_attention_map_plain(qkv, bias, logit_scale, shift,
                                          mxu_bf16)
    nWh, nWw = Hp // ws, Wp // ws
    _check_cuda(qkv, B * nWh * nWw, hd, "window_attention_map")
    dev, r = qkv.device, _mxu_bf16_default(mxu_bf16)
    qkv = qkv.contiguous()
    bias, scale = _f32(bias, dev), _f32(logit_scale.reshape(-1), dev)
    out = torch.empty((B, Hp, Wp, H, hd), dtype=torch.float32, device=dev)
    step = H * hd * qkv.element_size()
    err = _lib("window_attention_fwd")(
        qkv.data_ptr(), qkv.data_ptr() + step, qkv.data_ptr() + 2 * step,
        bias.data_ptr(), scale.data_ptr(), 0, out.data_ptr(),
        int(qkv.dtype == torch.bfloat16), 0, B * nWh * nWw,
        _geo(N, H, ws, shift, nWh, nWw, 0, r, r, True, Hp, Wp),
        torch.cuda.current_stream(dev).cuda_stream)
    window_attention_map_fwd.launches += 1
    _build.check(err, "window_attention_map_fwd")
    return out


def window_attention_map_bwd(qkv, bias, logit_scale, g, shift: int = 0,
                             mxu_bf16: bool = False):
    """Map-layout window attention backward (K7b): (dqkv fp32 [B, Hp, Wp, 3,
    H, hd], dbias [H, N, N] fp32, dscale [H] fp32) from qkv and the output
    gradient g [B, Hp, Wp, H, hd]. CUDA tensors run
    ``csrc/window_attention.cu``; CPU tensors
    ``window_attention_map_bwd_plain``."""
    B, Hp, Wp, H, hd, ws, N = _map_geometry(qkv, bias, logit_scale,
                                            "window_attention_map_bwd")
    if tuple(g.shape) != (B, Hp, Wp, H, hd):
        raise ValueError(f"window_attention_map_bwd: g {tuple(g.shape)} does "
                         f"not fit qkv {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return window_attention_map_bwd_plain(qkv, bias, logit_scale, g,
                                              shift, mxu_bf16)
    nWh, nWw = Hp // ws, Wp // ws
    Bn = B * nWh * nWw
    _check_cuda(qkv, Bn, hd, "window_attention_map_bwd")
    dev, r = qkv.device, _mxu_bf16_default(mxu_bf16)
    qkv, g = qkv.contiguous(), _f32(g, dev)
    bias, scale = _f32(bias, dev), _f32(logit_scale.reshape(-1), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dqkv = torch.empty(qkv.shape, **f32)
    dbias, dscale = torch.empty((H, N, N), **f32), torch.empty((H,), **f32)
    lr, tt = torch.empty((Bn, H, N), **f32), torch.empty((Bn, H, N), **f32)
    part = torch.empty(((-(-N // 64)) ** 2 * H,), **f32)
    step, dstep = H * hd * qkv.element_size(), H * hd * 4
    err = _lib("window_attention_bwd")(
        qkv.data_ptr(), qkv.data_ptr() + step, qkv.data_ptr() + 2 * step,
        bias.data_ptr(), scale.data_ptr(), 0, g.data_ptr(),
        dqkv.data_ptr(), dqkv.data_ptr() + dstep, dqkv.data_ptr() + 2 * dstep,
        dbias.data_ptr(), dscale.data_ptr(), lr.data_ptr(), tt.data_ptr(),
        part.data_ptr(), int(qkv.dtype == torch.bfloat16), 0, Bn,
        _geo(N, H, ws, shift, nWh, nWw, 0, r, r, True, Hp, Wp),
        torch.cuda.current_stream(dev).cuda_stream)
    window_attention_map_bwd.launches += 1
    _build.check(err, "window_attention_map_bwd")
    return dqkv, dbias, dscale


window_attention_fwd.launches = 0
window_attention_bwd.launches = 0
window_attention_map_fwd.launches = 0
window_attention_map_bwd.launches = 0


class _WindowAttention(torch.autograd.Function):
    """K8 forward; K8b backward from the saved inputs (nothing else is
    saved: the backward recomputes the softmax)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, logit_scale, mask):
        ctx.save_for_backward(q, k, v, bias, logit_scale)
        ctx.mask = mask
        return window_attention_fwd(q, k, v, bias, logit_scale, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, logit_scale = ctx.saved_tensors
        dq, dk, dv, dbias, dscale = window_attention_bwd(
            q, k, v, bias, logit_scale, g, ctx.mask)
        return (dq, dk, dv, dbias.to(bias.dtype),
                dscale.to(logit_scale.dtype).reshape(logit_scale.shape), None)


class _WindowAttentionMap(torch.autograd.Function):
    """K7 forward; K7b backward, its fp32 dqkv cast back to qkv's dtype."""

    @staticmethod
    def forward(ctx, qkv, bias, logit_scale, shift, mxu_bf16):
        ctx.save_for_backward(qkv, bias, logit_scale)
        ctx.static = (shift, mxu_bf16)
        return window_attention_map_fwd(qkv, bias, logit_scale, shift,
                                        mxu_bf16)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, logit_scale = ctx.saved_tensors
        dqkv, dbias, dscale = window_attention_map_bwd(
            qkv, bias, logit_scale, g, *ctx.static)
        return (dqkv.to(qkv.dtype), dbias.to(bias.dtype),
                dscale.to(logit_scale.dtype).reshape(logit_scale.shape),
                None, None)


def window_attention(q, k, v, bias, logit_scale, mask=None):
    """Differentiable head-layout window attention (K8 forward, K8b
    backward). ``mask`` [nW, N, N] (array or tensor) is not differentiated."""
    return _WindowAttention.apply(q, k, v, bias, logit_scale,
                                  _mask_tensor(mask, q.device))


def window_attention_map(qkv, bias, logit_scale, shift: int = 0,
                         mxu_bf16: bool = False):
    """Differentiable map-layout window attention with a static shift (K7
    forward, K7b backward). ``mxu_bf16`` rounds the product operands (q̂, k̂,
    p, v, g, ds) to bf16 inside the kernels; sums, softmax and the
    normalisation stay fp32."""
    return _WindowAttentionMap.apply(qkv, bias, logit_scale, int(shift),
                                     _mxu_bf16_default(mxu_bf16))
