"""SwinV2 window attention: the flat layout's K1 (forward), K2 and K5
(backward) kernels, the head and map layouts' K7-K8b, their plain
versions, and the autograd functions that join them.

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
``pallas_window_attention_flat_bwd``) run CUDA kernels for CUDA tensors —
the tensor-core passes of ``csrc/window_attention.cu`` that K7-K8b run
too: K1 one fixed-shift pass (its arithmetic ``_flat_fwd_split``), K2 and
K5 the backward passes (``_flat_bwd_split``; K2 forms dq, dk and dv in one
fused pass where ``_k2_fused`` holds) — and the plain versions for
CPU tensors; they never fall back from one to the other. ``flat_attention``
is the training entry. Its backward generation follows ``MVULD_ATTN_BWD``
as in the JAX package: v2 (the default) runs K1 with its reciprocal row
sums r = 1/max(Σe, 1e-30) ([Bn, H, N] fp32) in the forward and K2 from
the saved (qkv, bias, scale, out, r); v1 (``MVULD_ATTN_BWD=v1``) saves
only (qkv, bias, scale) and K5 recomputes the softmax statistics. Neither
backward replays K1. All of them follow ``MVULD_ATTN_MXU_BF16`` (or
``mxu_bf16=True``) as the JAX package's flat attention does: the product
operands rounded to bf16, the sums fp32. ``window_attention_flat_sharded``
is the sequence-parallel form over a process group: each rank runs K1 and
K2 (or K5) on its block of windows.

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
versions for CPU tensors; the kernels form their products on the bf16
tensor cores from split operands (``csrc/attn_mma.cuh``), which
``_core_fwd_split`` (the forwards: a row pass, then the output pass) and
``_core_bwd_split`` repeat in plain PyTorch for the CPU tests. The JAX
module's mask registry (``register_mask`` / ``make_window_attention``)
exists only to give ``custom_vjp`` a static argument; here the mask is a
plain non-differentiable argument of the autograd function.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import numpy as np
import torch

from mvuld_tpu_torch.ops import _build
from mvuld_tpu_torch.parallel import collectives as cc

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


def _mxu_bf16_default(mxu_bf16: bool) -> bool:
    """``MVULD_ATTN_MXU_BF16=1`` rounds the attention kernels' product
    operands to bf16 (the JAX package's switch), as ``mxu_bf16=True`` does."""
    return bool(mxu_bf16) or os.environ.get("MVULD_ATTN_MXU_BF16", "0") == "1"


def _r16(x, on: bool):
    """x rounded to bf16 and back, when ``on``."""
    return x.to(torch.bfloat16).float() if on else x


def window_attention_flat_plain(qkv, bias, logit_scale, shift: int = 0,
                                nWh: int = 1, nWw: int = 1,
                                return_rowsum: bool = False,
                                mxu_bf16: bool = False):
    """Plain PyTorch version of the K1 kernel (same math, same layout);
    with ``return_rowsum`` also the reciprocal row sums [Bn, H, N] fp32.
    ``mxu_bf16`` (or ``MVULD_ATTN_MXU_BF16=1``) rounds q̂, k̂, e and v to
    bf16 before their products, as the Pallas kernel does; the row sums
    stay fp32 sums of e."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    rnd = _mxu_bf16_default(mxu_bf16)
    q, k, v, _, _ = _normalised_qkv(qkv, Bn, N, H, C // H)
    scale, m = shift_and_scale(logit_scale, bias)
    s = _r16(q, rnd) @ _r16(k, rnd).transpose(-1, -2)
    s = _add_shift_mask(s * scale[:, None, None] + bias.float(), qkv, ws,
                        shift, nWh, nWw)
    e = torch.exp(s - m[:, None, None])
    denom = e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = ((_r16(e, rnd) @ _r16(v, rnd)) / denom).permute(0, 2, 1, 3)
    out = out.reshape(Bn, N, C).to(qkv.dtype)
    return (out, 1.0 / denom[..., 0]) if return_rowsum else out


def window_attention_flat_bwd_plain(qkv, bias, logit_scale, o, r, g,
                                    shift: int = 0, nWh: int = 1,
                                    nWw: int = 1, mxu_bf16: bool = False):
    """Plain PyTorch version of K2 (``_flat_bwd2_body``): from the forward
    output ``o`` and row sums ``r``, returns (dqkv [Bn, N, 3C] in qkv's
    dtype, dbias [H, N, N] fp32, dscale [H] fp32). ``mxu_bf16`` rounds q̂,
    k̂, g, v, ds and p to bf16 before their products, as the Pallas body
    does."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    rnd = _mxu_bf16_default(mxu_bf16)
    hd = C // H
    qh, kh, v, qn, kn = _normalised_qkv(qkv, Bn, N, H, hd)
    scale, m = shift_and_scale(logit_scale, bias)
    gh, oh = _heads(g, Bn, N, H, hd), _heads(o, Bn, N, H, hd)
    q16, k16, g16 = _r16(qh, rnd), _r16(kh, rnd), _r16(gh, rnd)
    s = (q16 @ k16.transpose(-1, -2)) * scale[:, None, None] + bias.float()
    s = s + (torch.log(r.float()) - m[:, None])[..., None]
    p = torch.exp(_add_shift_mask(s, qkv, ws, shift, nWh, nWw))
    t = (gh * oh).sum(-1, keepdim=True)
    ds = p * (g16 @ _r16(v, rnd).transpose(-1, -2) - t)
    ds16 = _r16(ds, rnd)
    dqh = (ds16 @ k16) * scale[:, None, None]
    rowq = (qh * dqh).sum(-1, keepdim=True)
    dkh = (ds16.transpose(-1, -2) @ q16) * scale[:, None, None]
    dv = _r16(p, rnd).transpose(-1, -2) @ g16
    dq = (dqh - qh * rowq) * qn
    dk = (dkh - kh * (kh * dkh).sum(-1, keepdim=True)) * kn
    dqkv = torch.stack([dq, dk, dv], 2)                    # [Bn, H, 3, N, hd]
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(Bn, N, 3 * C).to(qkv.dtype)
    return dqkv, ds.sum(0), rowq.sum((0, 2, 3)) / scale


def window_attention_flat_bwd_v1_plain(qkv, bias, logit_scale, g,
                                       shift: int = 0, nWh: int = 1,
                                       nWw: int = 1, mxu_bf16: bool = False):
    """Plain PyTorch version of K5 (``_flat_bwd_kernel_factory``): from the
    forward's inputs alone, returns (dqkv [Bn, N, 3C] in qkv's dtype,
    dbias [H, N, N] fp32, dscale [H] fp32). The softmax is recomputed as
    e = exp(s − m) with r = 1/max(Σe, 1e-30) and t = Σ dp·e, and
    ds = e·(r·(dp − r·t)) in that order: r may reach 1e30, and r² would
    overflow fp32. ``mxu_bf16`` rounds q̂, k̂, g, v, ds, e and r·g to bf16
    before their products, as the Pallas kernel does."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    rnd = _mxu_bf16_default(mxu_bf16)
    hd = C // H
    qh, kh, v, qn, kn = _normalised_qkv(qkv, Bn, N, H, hd)
    scale, m = shift_and_scale(logit_scale, bias)
    gh = _heads(g, Bn, N, H, hd)
    q16, k16 = _r16(qh, rnd), _r16(kh, rnd)
    s_cos = q16 @ k16.transpose(-1, -2)
    s = s_cos * scale[:, None, None] + (bias.float() - m[:, None, None])
    e = torch.exp(_add_shift_mask(s, qkv, ws, shift, nWh, nWw))
    r = 1.0 / e.sum(-1, keepdim=True).clamp_min(1e-30)
    dp = _r16(gh, rnd) @ _r16(v, rnd).transpose(-1, -2)
    t = (dp * e).sum(-1, keepdim=True)
    ds = e * (r * (dp - r * t))
    ds16 = _r16(ds, rnd)
    dqh = (ds16 @ k16) * scale[:, None, None]
    dkh = (ds16.transpose(-1, -2) @ q16) * scale[:, None, None]
    dv = _r16(e, rnd).transpose(-1, -2) @ _r16(r * gh, rnd)
    dq = (dqh - qh * (qh * dqh).sum(-1, keepdim=True)) * qn
    dk = (dkh - kh * (kh * dkh).sum(-1, keepdim=True)) * kn
    dqkv = torch.stack([dq, dk, dv], 2)                    # [Bn, H, 3, N, hd]
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(Bn, N, 3 * C).to(qkv.dtype)
    return dqkv, ds.sum(0), (ds * s_cos).sum((0, 2, 3))


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_GEO = ctypes.POINTER(ctypes.c_int)
# C entry → (source under csrc/, argument types)
_ENTRIES = {
    "window_attention_flat_fwd": ("window_attention",
                                  [_PTR] * 7 + [_INT] * 2 + [_GEO, _PTR]),
    "window_attention_flat_bwd": ("window_attention",
                                  [_PTR] * 17 + [_INT] * 3 + [_GEO, _PTR]),
    "window_attention_fwd": ("window_attention",
                             [_PTR] * 9 + [_INT] * 3 + [_GEO, _PTR]),
    "window_attention_bwd": ("window_attention",
                             [_PTR] * 18 + [_INT] * 4 + [_GEO, _PTR]),
    "window_attention_flat_bwd_fused": ("window_attention", [_INT]),
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


def _geo(N, H, ws=0, shift=0, nWh=0, nWw=0, nWmask=0, round_ops=False,
         round_p=False, layout=0, Hp=0, Wp=0):
    """The twelve integers of ``make_geo`` in ``csrc/window_attention.cu``;
    ``layout`` 0 head, 1 map, 2 flat."""
    return (ctypes.c_int * 12)(N, H, ws, int(shift), nWh, nWw, nWmask,
                               int(round_ops), int(round_p), layout, Hp, Wp)


def _f32(x, dev):
    return x.to(device=dev, dtype=torch.float32).contiguous()


def _aligned(x):
    """x at a 16-byte aligned address (the kernels load 16 bytes a thread):
    a view that starts elsewhere is copied."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _bwd_scratch(Bn, H, N, v_terms, g_terms, dev):
    """Scratch of ``window_attention_bwd`` and ``window_attention_flat_bwd``
    in ``csrc/window_attention.cu`` (its ``launch_bwd`` derives the same
    sizes): the row statistics lr, tt
    [Bn, H, N]; the number of window chunks dbias is summed in — enough
    that the blocks of its kernel (row blocks × 64-column tiles × H × chunks)
    fill the card's 132 SMs about four times — with the per-chunk dbias
    [chunks, H, N, N] when there is more than one; dscale's per-block
    partials; the product operands as bf16 terms (q̂ and k̂ three each, v and
    g ``v_terms`` and ``g_terms``: one for a bf16 tensor, two for fp32) and
    the two normalisation factors per row."""
    f32 = dict(dtype=torch.float32, device=dev)
    strips = -(-N // 16)
    tiles, col_tiles = -(-strips // 8), -(-16 * strips // 64)
    nchunk = max(1, min(Bn, -(-528 // (tiles * col_tiles * H))))
    nchunk = -(-Bn // -(-Bn // nchunk))          # no empty chunk
    part_db = torch.empty((nchunk, H, N, N) if nchunk > 1 else (1,), **f32)
    part_ds = torch.empty((nchunk * tiles * col_tiles * H,), **f32)
    ops = torch.empty((6 + v_terms + g_terms, Bn, H, N, _HEAD_DIM),
                      dtype=torch.bfloat16, device=dev)
    return (torch.empty((Bn, H, N), **f32), torch.empty((Bn, H, N), **f32),
            part_db, part_ds, ops, torch.empty((2, Bn, H, N), **f32), nchunk)


def _fwd_scratch(Bn, H, N, v_terms, exact, dev):
    """Scratch of the forward kernels in ``csrc/window_attention.cu``: the
    product operands as bf16 terms (q̂ and k̂ three each, v ``v_terms``:
    one for a bf16 tensor, two for fp32), (6 + v_terms)·Bn·H·N·64 bytes
    (7 × 51 MB at the bucket-16 stage 1, 7 × 205 MB at the batch-64
    fine-tune's), and for the exact softmax (``exact``) its row statistics
    lr [Bn, H, N] fp32."""
    ops = torch.empty((6 + v_terms, Bn, H, N, _HEAD_DIM), dtype=torch.bfloat16,
                      device=dev)
    lr = (torch.empty((Bn, H, N), dtype=torch.float32, device=dev) if exact
          else None)
    return ops, lr


def window_attention_flat(qkv, bias, logit_scale, shift: int = 0,
                          nWh: int = 1, nWw: int = 1,
                          return_rowsum: bool = False,
                          mxu_bf16: bool = False):
    """Flat-layout fused window attention forward (K1).

    CUDA tensors run the one-pass tensor-core forward of
    ``csrc/window_attention.cu`` (qkv in bf16 or fp32, head dim 32;
    anything else raises; ``_flat_fwd_split`` is its arithmetic); CPU
    tensors run ``window_attention_flat_plain``. With ``return_rowsum``
    also returns the reciprocal row sums [Bn, H, N] fp32; ``mxu_bf16`` (or
    ``MVULD_ATTN_MXU_BF16=1``) rounds the product operands to bf16."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    if qkv.device.type == "cpu":
        return window_attention_flat_plain(qkv, bias, logit_scale, shift,
                                           nWh, nWw, return_rowsum, mxu_bf16)
    _check_cuda(qkv, Bn, C // H, "window_attention_flat")
    dev = qkv.device
    qkv = _aligned(qkv.contiguous())
    bias, scale, m = _kernel_scalars(qkv, bias, logit_scale)
    out = torch.empty((Bn, N, C), dtype=qkv.dtype, device=dev)
    r = (torch.empty((Bn, H, N), dtype=torch.float32, device=dev)
         if return_rowsum else None)
    bf = int(qkv.dtype == torch.bfloat16)
    ops, _ = _fwd_scratch(Bn, H, N, 2 - bf, False, dev)
    rnd = _mxu_bf16_default(mxu_bf16)
    err = _lib("window_attention_flat_fwd")(
        qkv.data_ptr(), bias.data_ptr(), scale.data_ptr(), m.data_ptr(),
        out.data_ptr(), 0 if r is None else r.data_ptr(), ops.data_ptr(), bf,
        Bn, _geo(N, H, ws, shift, nWh, nWw, 0, rnd, rnd, 2),
        torch.cuda.current_stream(dev).cuda_stream)
    window_attention_flat.launches += 1
    _build.check(err, "window_attention_flat")
    return (out, r) if return_rowsum else out


def _flat_bwd_kernels(what, qkv, bias, logit_scale, o, r, g, shift, nWh, nWw,
                      mxu_bf16):
    """Launch K2 (``o`` and ``r`` the forward's) or K5 (both None) on the
    tensor-core passes of ``csrc/window_attention.cu``."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    _check_cuda(qkv, Bn, C // H, what)
    dev, dt = qkv.device, qkv.dtype
    qkv, g = _aligned(qkv.contiguous()), _aligned(g.to(dt).contiguous())
    if o is not None:
        o = _aligned(o.to(dt).contiguous())
        r = r.to(device=dev, dtype=torch.float32).contiguous()
    bias, scale, m = _kernel_scalars(qkv, bias, logit_scale)
    dqkv = torch.empty_like(qkv)
    f32 = dict(dtype=torch.float32, device=dev)
    dbias, dscale = torch.empty((H, N, N), **f32), torch.empty((H,), **f32)
    bf = int(dt == torch.bfloat16)
    lr, tt, part_db, part_ds, ops, norms, nchunk = _bwd_scratch(
        Bn, H, N, 2 - bf, 2 - bf, dev)
    # K2's dscale terms q̂·dq̂ / scale per query row
    rowq = None if o is None else torch.empty((Bn, H, N), **f32)
    rnd = _mxu_bf16_default(mxu_bf16)
    err = _lib("window_attention_flat_bwd")(
        qkv.data_ptr(), bias.data_ptr(), scale.data_ptr(), m.data_ptr(),
        0 if o is None else o.data_ptr(), 0 if r is None else r.data_ptr(),
        g.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(), dscale.data_ptr(),
        lr.data_ptr(), tt.data_ptr(), 0 if rowq is None else rowq.data_ptr(),
        part_db.data_ptr(), part_ds.data_ptr(), ops.data_ptr(),
        norms.data_ptr(), nchunk, bf, Bn,
        _geo(N, H, ws, shift, nWh, nWw, 0, rnd, rnd, 2),
        torch.cuda.current_stream(dev).cuda_stream)
    return err, (dqkv, dbias, dscale)


def _k2_fused(N: int) -> bool:
    """Whether K2 forms dq, dk and dv in its fused key-outer pass (N ≤
    1024) or in its separate dq and dk/dv passes: the decision
    ``launch_bwd`` of ``csrc/window_attention.cu`` takes, asked of the
    library."""
    return bool(_lib("window_attention_flat_bwd_fused")(N))


def window_attention_flat_bwd(qkv, bias, logit_scale, o, r, g,
                              shift: int = 0, nWh: int = 1, nWw: int = 1,
                              mxu_bf16: bool = False):
    """Flat-layout window attention backward (K2): (dqkv [Bn, N, 3C] in
    qkv's dtype, dbias [H, N, N] fp32, dscale [H] fp32) from the forward's
    output ``o`` and row sums ``r`` and the output gradient ``g``.

    CUDA tensors run the tensor-core passes of ``csrc/window_attention.cu``
    (operands split into bf16 terms with the row terms from ``o`` and
    ``r``, then dq, dk and dv in one fused pass where ``_k2_fused`` holds,
    counted by ``fused_launches``, else a dq and a dk/dv pass, then dbias +
    dscale; ``_flat_bwd_split`` is their arithmetic); CPU tensors run
    ``window_attention_flat_bwd_plain``."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    if tuple(o.shape) != (Bn, N, C) or tuple(g.shape) != (Bn, N, C) \
            or tuple(r.shape) != (Bn, H, N):
        raise ValueError(f"window_attention_flat_bwd: o {tuple(o.shape)}, "
                         f"g {tuple(g.shape)}, r {tuple(r.shape)} do not fit "
                         f"[Bn={Bn}, N={N}, C={C}], H={H}")
    if qkv.device.type == "cpu":
        return window_attention_flat_bwd_plain(qkv, bias, logit_scale, o, r,
                                               g, shift, nWh, nWw, mxu_bf16)
    err, grads = _flat_bwd_kernels("window_attention_flat_bwd", qkv, bias,
                                   logit_scale, o, r, g, shift, nWh, nWw,
                                   mxu_bf16)
    window_attention_flat_bwd.launches += 1
    if _k2_fused(qkv.shape[1]):
        window_attention_flat_bwd.fused_launches += 1
    _build.check(err, "window_attention_flat_bwd")
    return grads


def window_attention_flat_bwd_v1(qkv, bias, logit_scale, g, shift: int = 0,
                                 nWh: int = 1, nWw: int = 1,
                                 mxu_bf16: bool = False):
    """Flat-layout window attention v1 backward (K5): (dqkv [Bn, N, 3C] in
    qkv's dtype, dbias [H, N, N] fp32, dscale [H] fp32) from the forward's
    inputs and the output gradient ``g`` alone.

    CUDA tensors run K2's passes of ``csrc/window_attention.cu`` after a
    fixed-shift row pass that recomputes r and t' = r·Σ dp·e; CPU tensors
    run ``window_attention_flat_bwd_v1_plain``."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    if tuple(g.shape) != (Bn, N, C):
        raise ValueError(f"window_attention_flat_bwd_v1: g {tuple(g.shape)} "
                         f"does not fit [Bn={Bn}, N={N}, C={C}]")
    if qkv.device.type == "cpu":
        return window_attention_flat_bwd_v1_plain(qkv, bias, logit_scale, g,
                                                  shift, nWh, nWw, mxu_bf16)
    err, grads = _flat_bwd_kernels("window_attention_flat_bwd_v1", qkv, bias,
                                   logit_scale, None, None, g, shift, nWh,
                                   nWw, mxu_bf16)
    window_attention_flat_bwd_v1.launches += 1
    _build.check(err, "window_attention_flat_bwd_v1")
    return grads


window_attention_flat.launches = 0
window_attention_flat_bwd.launches = 0
window_attention_flat_bwd.fused_launches = 0
window_attention_flat_bwd_v1.launches = 0


def _flat_bwd_v2_default() -> bool:
    """v2 backward unless ``MVULD_ATTN_BWD=v1`` (the JAX package's switch)."""
    return os.environ.get("MVULD_ATTN_BWD", "v2").lower() != "v1"


class _FlatAttention(torch.autograd.Function):
    """K1 forward with row sums; K2 backward from the saved residuals. The
    logit scale enters as the already exp-clamped per-head scale [H]."""

    @staticmethod
    def forward(ctx, qkv, bias, scale, shift, nWh, nWw, saved, mxu_bf16):
        if saved is None:
            out, r = window_attention_flat(qkv, bias, scale, shift, nWh, nWw,
                                           return_rowsum=True,
                                           mxu_bf16=mxu_bf16)
        else:
            out, r = saved[0].detach(), saved[1].detach()
        ctx.geom = (shift, nWh, nWw, mxu_bf16)
        ctx.save_for_backward(qkv, bias, scale, out, r)
        ctx.mark_non_differentiable(r)
        return out, r

    @staticmethod
    def backward(ctx, g, _g_r):
        qkv, bias, scale, out, r = ctx.saved_tensors
        dqkv, dbias, dscale = window_attention_flat_bwd(
            qkv, bias, scale, out, r, g, *ctx.geom)
        return (dqkv, dbias.to(bias.dtype), dscale.to(scale.dtype),
                None, None, None, None, None)


class _FlatAttentionV1(torch.autograd.Function):
    """K1 forward; K5 backward from (qkv, bias, scale) alone, as the JAX v1
    VJP saves only the kernel's inputs."""

    @staticmethod
    def forward(ctx, qkv, bias, scale, shift, nWh, nWw, saved, mxu_bf16):
        out = (window_attention_flat(qkv, bias, scale, shift, nWh, nWw,
                                     mxu_bf16=mxu_bf16)
               if saved is None else saved[0].detach())
        ctx.geom = (shift, nWh, nWw, mxu_bf16)
        ctx.save_for_backward(qkv, bias, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, bias, scale = ctx.saved_tensors
        dqkv, dbias, dscale = window_attention_flat_bwd_v1(
            qkv, bias, scale, g, *ctx.geom)
        return (dqkv, dbias.to(bias.dtype), dscale.to(scale.dtype),
                None, None, None, None, None)


def flat_attention(qkv, bias, scale, shift: int = 0, nWh: int = 1,
                   nWw: int = 1, saved=None, bwd_v2: Optional[bool] = None,
                   mxu_bf16: bool = False):
    """Differentiable flat window attention: K1 forward, K2 (``bwd_v2``,
    the default unless ``MVULD_ATTN_BWD=v1``) or K5 backward.

    Returns (out, r), r the row sums under v2 and None under v1.
    ``saved``, a previous call's (out, r) on the same inputs, skips K1:
    under activation checkpointing the recomputed forward reuses the first
    forward's output (and row sums), as the JAX remat policy saves
    ``attn_out`` / ``attn_rowsum``. ``mxu_bf16`` (default: the
    ``MVULD_ATTN_MXU_BF16`` switch, as in the JAX package) rounds the
    product operands of the forward and the backward to bf16."""
    if bwd_v2 is None:
        bwd_v2 = _flat_bwd_v2_default()
    mxu_bf16 = _mxu_bf16_default(mxu_bf16)
    if bwd_v2:
        return _FlatAttention.apply(qkv, bias, scale, shift, nWh, nWw, saved,
                                    mxu_bf16)
    return (_FlatAttentionV1.apply(qkv, bias, scale, shift, nWh, nWw, saved,
                                   mxu_bf16), None)


class _ShardedFlatAttention(torch.autograd.Function):
    """``window_attention_flat_sharded``'s forward and backward: K1 on this
    rank's block of windows, the outputs gathered; K2 (K5 under v1) on the
    block, dqkv gathered, dbias and dscale summed over the group."""

    @staticmethod
    def forward(ctx, qkv, bias, scale, shift, nWh, nWw, group, saved,
                mxu_bf16, bwd_v2):
        n = qkv.shape[0] // cc.size(group)
        lo = cc.rank(group) * n
        mine = qkv[lo:lo + n]
        if saved is None:
            out_mine, r = window_attention_flat(mine, bias, scale, shift, nWh,
                                                nWw, return_rowsum=True,
                                                mxu_bf16=mxu_bf16)
            out = cc.all_gather(out_mine, group)
        else:
            out, r = saved[0].detach(), saved[1].detach()
            out_mine = out[lo:lo + n]
        ctx.geom = (shift, nWh, nWw, mxu_bf16)
        ctx.group, ctx.lo, ctx.bwd_v2 = group, lo, bwd_v2
        ctx.save_for_backward(mine, bias, scale, out_mine, r)
        ctx.mark_non_differentiable(r)
        return out, r

    @staticmethod
    def backward(ctx, g, _g_r):
        mine, bias, scale, out_mine, r = ctx.saved_tensors
        g_mine = g[ctx.lo:ctx.lo + mine.shape[0]].contiguous()
        if ctx.bwd_v2:
            dq, dbias, dscale = window_attention_flat_bwd(
                mine, bias, scale, out_mine, r, g_mine, *ctx.geom)
        else:
            dq, dbias, dscale = window_attention_flat_bwd_v1(
                mine, bias, scale, g_mine, *ctx.geom)
        return (cc.all_gather(dq, ctx.group),
                cc.all_reduce(dbias, ctx.group).to(bias.dtype),
                cc.all_reduce(dscale, ctx.group).to(scale.dtype),
                None, None, None, None, None, None, None)


def window_attention_flat_sharded(qkv, bias, scale, shift: int, nWh: int,
                                  nWw: int, group, saved=None,
                                  bwd_v2: Optional[bool] = None,
                                  mxu_bf16: bool = False):
    """Sequence-parallel flat window attention (the JAX
    ``window_attention_flat_sharded``): the window axis of a program that
    every rank of ``group`` runs alike is split into the ranks' contiguous
    blocks. Each rank runs K1 on its block and the outputs are gathered, so
    every rank holds the whole [Bn, N, C] output; the backward runs K2 (K5
    under ``MVULD_ATTN_BWD=v1``) on the block, gathers dqkv and sums the
    dbias [H, N, N] and dscale [H] partials over the group — shard_map's
    semantics with replicated inputs.

    Returns (out, r), r this rank's row sums [Bn/k, H, N]; ``saved``, a
    previous call's (out, r) on the same inputs, skips K1 (checkpointed
    stages). Each block must hold whole images' window sets, so that the
    kernel's window id modulo nW stays each window's boundary mask."""
    Bn = qkv.shape[0]
    nW = max(nWh * nWw, 1)
    k = cc.size(group)
    if (Bn // nW) % k != 0:
        raise ValueError(
            f"sequence-parallel window attention: batch {Bn // nW} (Bn={Bn}, "
            f"nW={nW}) must be a multiple of the group size {k}")
    if bwd_v2 is None:
        bwd_v2 = _flat_bwd_v2_default()
    return _ShardedFlatAttention.apply(qkv, bias, scale, shift, nWh, nWw,
                                       group, saved,
                                       _mxu_bf16_default(mxu_bf16), bwd_v2)


# --------------------------------------------------------------------------- #
# head layout (K8 / K8b) and map layout (K7 / K7b): exact softmax
# --------------------------------------------------------------------------- #


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


def _split16(x, parts: int):
    """fp32 x as ``parts`` bf16-valued fp32 terms, each the bf16 rounding of
    what the terms before it left: x ≈ Σ terms (2⁻¹⁸ relative with two,
    exact to fp32 with three)."""
    terms, rest = [], x
    for _ in range(parts):
        terms.append(_r16(rest, True))
        rest = rest - terms[-1]
    return terms


def _mm_split(a, b, order: int):
    """Σ a_i @ b_jᵀ over the term pairs with i + j ≤ ``order``, in fp32: the
    bf16 tensor-core products the K7b/K8b kernels add for one fp32 product
    (the pairs past ``order`` are below 2⁻⁸⁽ᵒʳᵈᵉʳ⁺¹⁾ of it and dropped)."""
    total = None
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            if i + j <= order:
                term = ai @ bj.transpose(-1, -2)
                total = term if total is None else total + term
    return total


def _split_bwd(qh, kh, v, g, v_bf16, g_bf16, sc, probs, round_ops=False):
    """The backward kernels' products on bf16 terms (``_split16``) summed in
    fp32 (``_mm_split``), for a softmax given as ``probs(s_cos, dp)`` →
    (p, the row term t of ds = p·(dp − t)). q̂ and k̂ take three terms and
    six products for the logits (their error is multiplied by the scale, up
    to 100, before the exp), two terms and three products for dq̂ and dk̂;
    p, ds take two; v and g take one when they already are bf16 numbers
    (``v_bf16``, ``g_bf16``), two otherwise. ``round_ops`` (``mxu_bf16``)
    keeps the first term of each operand, one product each. Returns fp32
    (dq̂, dk̂, dv, dbias, dscale)."""
    hi, lo = (0, 0) if round_ops else (2, 1)
    q3, k3 = _split16(qh, 3), _split16(kh, 3)
    v2, g2 = _split16(v, 1 if v_bf16 else 2), _split16(g, 1 if g_bf16 else 2)
    s_cos = _mm_split(q3, k3, hi)
    dp = _mm_split(g2, v2, lo)
    p, t = probs(s_cos, dp)
    ds = p * (dp - t)
    dbias, dscale = ds.sum(0), (ds * s_cos).sum((0, 2, 3))
    tr = lambda parts: [x.transpose(-1, -2) for x in parts]  # noqa: E731
    ds2 = _split16(ds, 2)
    dv = _mm_split(tr(_split16(p, 2)), tr(g2), lo)
    dqh = _mm_split(ds2, tr(k3[:2]), lo) * sc
    dkh = _mm_split(tr(ds2), tr(q3[:2]), lo) * sc
    return dqh, dkh, dv, dbias, dscale


_LOG2E = 1.4426950408889634


def _fwd_products(qh, kh, v, v_bf16, round_ops, round_p, probs):
    """The forward kernels' products on bf16 terms (``_split16``) summed in
    fp32 (``_mm_split``), for a softmax given as ``probs(s_cos)`` → p (or
    e): s_cos from q̂ and k̂ in three terms each (six products), p·v from p
    in two terms (one under ``round_p``) and v in one when it already is a
    bf16 number (``v_bf16``) or under ``round_ops``, two otherwise (three
    products at most); ``round_ops`` keeps q̂'s and k̂'s first terms. Returns
    (p·v, p) in fp32."""
    order = 0 if round_ops else 2
    s_cos = _mm_split(_split16(qh, 3), _split16(kh, 3), order)
    p = probs(s_cos)
    vt = [t.transpose(-1, -2)
          for t in _split16(v, 1 if v_bf16 or round_ops else 2)]
    return _mm_split(_split16(p, 1 if round_p else 2), vt, 1), p


def _core_fwd_split(q, k, v, bias, scale, mask, v_bf16, round_ops=False,
                    round_p=False):
    """K7 / K8 as the forward passes of ``csrc/window_attention.cu`` compute
    them (``_fwd_products``): a row pass gives lr2 = −(max y + log₂ Σ
    2^(y − max y)) of y = x·log₂e per query row, and the output pass forms
    p = 2^(y + lr2), normalised before it is rounded (``round_p``: K8 rounds
    p to v's dtype, ``mxu_bf16`` every operand), and adds p·v. fp32 q, k, v
    [Bn, H, N, hd] → fp32 [Bn, H, N, hd]. The CPU tests hold it to the
    card's tolerances against the JAX kernels; no CUDA path calls it."""
    qh = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    kh = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)

    def probs(s_cos):
        y = _add_mask(s_cos * scale[:, None, None] + bias.float(),
                      mask) * _LOG2E
        mx = y.amax(-1, keepdim=True)
        lr2 = -(mx + torch.log2(torch.exp2(y - mx).sum(-1, keepdim=True)))
        return torch.exp2(y + lr2)

    return _fwd_products(qh, kh, v, v_bf16, round_ops, round_p, probs)[0]


def _flat_fwd_split(qkv, bias, logit_scale, shift=0, nWh=1, nWw=1,
                    mxu_bf16=False):
    """K1 as the one-pass forward of ``csrc/window_attention.cu`` computes
    it (``_fwd_products``): e = 2^(x·log₂e − m_h·log₂e), the fixed-shift
    softmax's unnormalised exp, its row sums Σe in fp32 from the unrounded
    e, out = (e·v)·r with r = 1/max(Σe, 1e-30); ``mxu_bf16`` rounds q̂, k̂,
    e and v. Returns fp32 (out [Bn, N, C], r [Bn, H, N]). The CPU tests hold
    it to the card's tolerances against the JAX kernel; no CUDA path calls
    it."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    qh, kh, v, _, _ = _normalised_qkv(qkv, Bn, N, H, C // H)
    scale, m = shift_and_scale(logit_scale, bias)
    rnd = _mxu_bf16_default(mxu_bf16)

    def probs(s_cos):
        x = _add_shift_mask(s_cos * scale[:, None, None] + bias.float(), qkv,
                            ws, shift, nWh, nWw)
        return torch.exp2(x * _LOG2E - (m * _LOG2E)[:, None, None])

    ev, e = _fwd_products(qh, kh, v, qkv.dtype == torch.bfloat16, rnd, rnd,
                          probs)
    r = 1.0 / e.sum(-1).clamp_min(1e-30)
    out = (ev * r[..., None]).permute(0, 2, 1, 3).reshape(Bn, N, C)
    return out, r


def _core_bwd_split(q, k, v, bias, scale, mask, g, v_bf16, g_bf16):
    """``_core_bwd`` with every product formed as the K7b/K8b kernels form
    it when ``round_ops`` is off (``_split_bwd``). The CPU tests hold this
    arithmetic to the card's tolerances against the JAX kernels; no CUDA
    path calls it."""
    qn = torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    kn = torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    qh, kh = q * qn, k * kn
    sc = scale[:, None, None]

    def probs(s_cos, dp):
        p = torch.softmax(_add_mask(s_cos * sc + bias.float(), mask), dim=-1)
        return p, (dp * p).sum(-1, keepdim=True)

    dqh, dkh, dv, dbias, dscale = _split_bwd(qh, kh, v, g, v_bf16, g_bf16, sc,
                                             probs)
    dq = (dqh - qh * (qh * dqh).sum(-1, keepdim=True)) * qn
    dk = (dkh - kh * (kh * dkh).sum(-1, keepdim=True)) * kn
    return dq, dk, dv, dbias, dscale


def _flat_bwd_split(qkv, bias, logit_scale, g, shift=0, nWh=1, nWw=1, o=None,
                    r=None, mxu_bf16=False):
    """K2 (``o``, ``r`` the forward's) or K5 (both None) as the kernels of
    ``csrc/window_attention.cu`` compute them (``_split_bwd``), with the
    fixed-shift softmax: p = exp(s − m + log r), t = rowsum(g·o) and
    dscale = Σ q̂·dq̂ / scale for K2, as its Pallas kernel forms them; for K5
    e = exp(s − m), r = 1/max(Σe, 1e-30), p = e·r, t = r·Σ dp·e and
    dscale = Σ ds·s_cos. Returns fp32 (dqkv [Bn, N, 3C], dbias, dscale).
    The CPU tests hold it to the card's tolerances against the JAX kernels;
    no CUDA path calls it."""
    Bn, N, C, H, ws = _geometry(qkv, bias, logit_scale, shift, nWh, nWw)
    hd = C // H
    qh, kh, v, qn, kn = _normalised_qkv(qkv, Bn, N, H, hd)
    scale, m = shift_and_scale(logit_scale, bias)
    sc = scale[:, None, None]
    gh = _heads(g, Bn, N, H, hd)

    def probs(s_cos, dp):
        x = _add_shift_mask(s_cos * sc + bias.float(), qkv, ws, shift, nWh,
                            nWw) - m[:, None, None]
        if o is not None:
            t = (gh * _heads(o, Bn, N, H, hd)).sum(-1, keepdim=True)
            return torch.exp(x + torch.log(r.float())[..., None]), t
        e = torch.exp(x)
        rs = 1.0 / e.sum(-1, keepdim=True).clamp_min(1e-30)
        return e * rs, rs * (dp * e).sum(-1, keepdim=True)

    bf = qkv.dtype == torch.bfloat16
    dqh, dkh, dv, dbias, dscale = _split_bwd(
        qh, kh, v, gh, bf, bf, sc, probs, _mxu_bf16_default(mxu_bf16))
    rowq = (qh * dqh).sum(-1, keepdim=True)
    if o is not None:
        dscale = rowq.sum((0, 2, 3)) / scale
    dq = (dqh - qh * rowq) * qn
    dk = (dkh - kh * (kh * dkh).sum(-1, keepdim=True)) * kn
    dqkv = torch.stack([dq, dk, dv], 2)                    # [Bn, H, 3, N, hd]
    return dqkv.permute(0, 3, 2, 1, 4).reshape(Bn, N, 3 * C), dbias, dscale


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


def window_attention_fwd(q, k, v, bias, logit_scale, mask=None):
    """Head-layout window attention forward (K8): q, k, v [Bn, H, N, hd],
    bias [H, N, N], logit_scale [H], mask [nW, N, N] or None → [Bn, H, N,
    hd] in q's dtype. CUDA tensors run the tensor-core forward passes of
    ``csrc/window_attention.cu`` (bf16 or fp32, head dim 32; anything else
    raises; ``_core_fwd_split`` is their arithmetic); CPU tensors run
    ``window_attention_plain``."""
    mask = _mask_tensor(mask, q.device)
    Bn, H, N, hd = _head_geometry(q, k, v, bias, logit_scale, mask,
                                  "window_attention")
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, logit_scale, mask)
    _check_cuda(q, Bn, hd, "window_attention")
    dev, dt = q.device, q.dtype
    q, k, v = (_aligned(t.to(dt).contiguous()) for t in (q, k, v))
    bias, scale = _f32(bias, dev), _f32(logit_scale.reshape(-1), dev)
    mask = None if mask is None else mask.contiguous()
    out = torch.empty_like(q)
    bf = int(dt == torch.bfloat16)
    ops, lr = _fwd_scratch(Bn, H, N, 2 - bf, True, dev)
    err = _lib("window_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        scale.data_ptr(), 0 if mask is None else mask.data_ptr(),
        out.data_ptr(), lr.data_ptr(), ops.data_ptr(), bf, bf, Bn,
        _geo(N, H, nWmask=0 if mask is None else mask.shape[0], round_p=bf),
        torch.cuda.current_stream(dev).cuda_stream)
    window_attention_fwd.launches += 1
    _build.check(err, "window_attention_fwd")
    return out


def window_attention_bwd(q, k, v, bias, logit_scale, g, mask=None):
    """Head-layout window attention backward (K8b), from the forward's
    inputs alone: (dq, dk, dv in the inputs' dtype, dbias [H, N, N] fp32,
    dscale [H] fp32). CUDA tensors run the tensor-core kernels of
    ``csrc/window_attention.cu`` (operands split into bf16 terms, then row
    statistics, dq, dk/dv, dbias + dscale; ``_core_bwd_split`` is their
    arithmetic); CPU tensors run ``window_attention_bwd_plain``."""
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
    q, k, v, g = (_aligned(t.to(dt).contiguous()) for t in (q, k, v, g))
    bias, scale = _f32(bias, dev), _f32(logit_scale.reshape(-1), dev)
    mask = None if mask is None else mask.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=dev)
    dbias, dscale = torch.empty((H, N, N), **f32), torch.empty((H,), **f32)
    bf = int(dt == torch.bfloat16)
    lr, tt, part_db, part_ds, ops, norms, nchunk = _bwd_scratch(
        Bn, H, N, 2 - bf, 2 - bf, dev)
    err = _lib("window_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        scale.data_ptr(), 0 if mask is None else mask.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbias.data_ptr(), dscale.data_ptr(), lr.data_ptr(), tt.data_ptr(),
        part_db.data_ptr(), part_ds.data_ptr(), ops.data_ptr(),
        norms.data_ptr(), nchunk, bf, bf, Bn,
        _geo(N, H, nWmask=0 if mask is None else mask.shape[0]),
        torch.cuda.current_stream(dev).cuda_stream)
    window_attention_bwd.launches += 1
    _build.check(err, "window_attention_bwd")
    return dq, dk, dv, dbias, dscale


def window_attention_map_fwd(qkv, bias, logit_scale, shift: int = 0,
                             mxu_bf16: bool = False):
    """Map-layout window attention forward (K7): qkv [B, Hp, Wp, 3, H, hd]
    as the projection writes it (already rolled for ``shift`` > 0), read in
    place → fp32 [B, Hp, Wp, H, hd]. CUDA tensors run the tensor-core
    forward passes of ``csrc/window_attention.cu`` (``_core_fwd_split`` is
    their arithmetic); CPU tensors ``window_attention_map_plain``."""
    B, Hp, Wp, H, hd, ws, N = _map_geometry(qkv, bias, logit_scale,
                                            "window_attention_map")
    if qkv.device.type == "cpu":
        return window_attention_map_plain(qkv, bias, logit_scale, shift,
                                          mxu_bf16)
    nWh, nWw = Hp // ws, Wp // ws
    Bn = B * nWh * nWw
    _check_cuda(qkv, Bn, hd, "window_attention_map")
    dev, r = qkv.device, _mxu_bf16_default(mxu_bf16)
    qkv = _aligned(qkv.contiguous())
    bias, scale = _f32(bias, dev), _f32(logit_scale.reshape(-1), dev)
    out = torch.empty((B, Hp, Wp, H, hd), dtype=torch.float32, device=dev)
    bf = int(qkv.dtype == torch.bfloat16)
    ops, lr = _fwd_scratch(Bn, H, N, 2 - bf, True, dev)
    step = H * hd * qkv.element_size()
    err = _lib("window_attention_fwd")(
        qkv.data_ptr(), qkv.data_ptr() + step, qkv.data_ptr() + 2 * step,
        bias.data_ptr(), scale.data_ptr(), 0, out.data_ptr(), lr.data_ptr(),
        ops.data_ptr(), bf, 0, Bn,
        _geo(N, H, ws, shift, nWh, nWw, 0, r, r, 1, Hp, Wp),
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
    qkv, g = _aligned(qkv.contiguous()), _aligned(_f32(g, dev))
    bias, scale = _f32(bias, dev), _f32(logit_scale.reshape(-1), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dqkv = torch.empty(qkv.shape, **f32)
    dbias, dscale = torch.empty((H, N, N), **f32), torch.empty((H,), **f32)
    lr, tt, part_db, part_ds, ops, norms, nchunk = _bwd_scratch(
        Bn, H, N, 1 if qkv.dtype == torch.bfloat16 else 2, 2, dev)
    step, dstep = H * hd * qkv.element_size(), H * hd * 4
    err = _lib("window_attention_bwd")(
        qkv.data_ptr(), qkv.data_ptr() + step, qkv.data_ptr() + 2 * step,
        bias.data_ptr(), scale.data_ptr(), 0, g.data_ptr(),
        dqkv.data_ptr(), dqkv.data_ptr() + dstep, dqkv.data_ptr() + 2 * dstep,
        dbias.data_ptr(), dscale.data_ptr(), lr.data_ptr(), tt.data_ptr(),
        part_db.data_ptr(), part_ds.data_ptr(), ops.data_ptr(),
        norms.data_ptr(), nchunk, int(qkv.dtype == torch.bfloat16), 0, Bn,
        _geo(N, H, ws, shift, nWh, nWw, 0, r, r, 1, Hp, Wp),
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
