"""Fused MLP + LayerNorm: the K3 (``mlp_ln``) and K4 (``mlp_ln_res``) kernels.

Counterparts of ``mvuld_tpu/ops/fused_dense.py`` ``mlp_ln`` (SwinBlockV2's
post-norm MLP half, LayerNorm eps 1e-6) and ``mlp_ln_res`` (the RoBERTa
layer's residual MLP half, eps 1e-5), forward only:

  mlp_ln:      y = LN(GELU(x@W1 + b1)@W2 + b2)·γ + β
  mlp_ln_res:  y = LN(x + GELU(x@W1 + b1)@W2 + b2)·γ + β

Weights are in the JAX layout (W1 ``[C, Hd]``, W2 ``[Hd, C]``) and are
cast to x's dtype before the products, which accumulate in fp32; the hidden
activation is rounded to x's dtype before the second product, as the Pallas
kernel does. GELU is the exact erf form (the Pallas kernel's polynomial erf
is a Mosaic workaround). This is the inference form: ``mlp_ln_res`` has
no dropout operand (the JAX kernel's mask with keep_prob 1); the training
slice adds it.

CUDA tensors run ``csrc/mlp_ln.cu`` (bf16 only; anything else raises); CPU
tensors run the plain versions. The wrappers never fall back from one to
the other.
"""

from __future__ import annotations

import ctypes

import torch

from mvuld_tpu_torch.ops import _build

_LN_EPS = 1e-6
_BERT_LN_EPS = 1e-5   # HF RobertaConfig.layer_norm_eps
_HIDDEN_CHUNK = 128   # the kernel's hidden chunk; Hd must be a multiple
_MAX_C = 1024         # the kernel's fp32 row-tile accumulator bound


def gelu(z):
    """Exact-erf GELU (nn.gelu(approximate=False) / torch nn.GELU())."""
    return 0.5 * z * (1.0 + torch.erf(z * 0.7071067811865476))


def _check_shapes(x, w1, b1, w2, b2, gamma, beta):
    C, Hd = w1.shape
    want = {"x": (x.shape[-1], C), "w2": (tuple(w2.shape), (Hd, C)),
            "b1": (tuple(b1.shape), (Hd,)), "b2": (tuple(b2.shape), (C,)),
            "gamma": (tuple(gamma.shape), (C,)),
            "beta": (tuple(beta.shape), (C,))}
    bad = {k: got for k, (got, exp) in want.items() if got != exp}
    if bad:
        raise ValueError(f"fused MLP+LN: shapes {bad} do not fit w1 "
                         f"[C={C}, Hd={Hd}]")


def mlp_ln_plain(x, w1, b1, w2, b2, gamma, beta, residual: bool = False,
                 eps: float = _LN_EPS):
    """Plain PyTorch version of K3 (``residual=False``) and K4."""
    _check_shapes(x, w1, b1, w2, b2, gamma, beta)
    dt = x.dtype
    C = x.shape[-1]
    xf = x.reshape(-1, C).float()
    h = gelu(xf @ w1.to(dt).float() + b1.float())
    z = h.to(dt).float() @ w2.to(dt).float() + b2.float()
    if residual:
        z = z + xf
    mu = z.mean(-1, keepdim=True)
    zc = z - mu
    var = (zc * zc).mean(-1, keepdim=True)
    y = zc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(dt).reshape(x.shape)


def _lib():
    fn = _build.load("mlp_ln").mlp_ln_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w1, b1, w2, b2, gamma, beta, residual: bool, eps: float,
            what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    _check_shapes(x, w1, b1, w2, b2, gamma, beta)
    C, Hd = w1.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what} kernel: x dtype {x.dtype} (want bfloat16)")
    if C % 16 or C > _MAX_C or Hd % _HIDDEN_CHUNK:
        raise ValueError(f"{what} kernel: C={C} must be a multiple of 16 and "
                         f"≤ {_MAX_C}, Hd={Hd} a multiple of {_HIDDEN_CHUNK}")
    dev = x.device
    x2 = x.reshape(-1, C).contiguous()
    M = x2.shape[0]
    bf = lambda w: w.to(device=dev, dtype=torch.bfloat16).contiguous()  # noqa: E731
    f32 = lambda v: v.to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    w1b, w2b = bf(w1), bf(w2)
    b1f, b2f, gf, bt = f32(b1), f32(b2), f32(gamma), f32(beta)
    out = torch.empty_like(x2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(x2.data_ptr(), w1b.data_ptr(), b1f.data_ptr(),
                 w2b.data_ptr(), b2f.data_ptr(), gf.data_ptr(), bt.data_ptr(),
                 out.data_ptr(), M, C, Hd, int(residual), eps, stream)
    return out.reshape(x.shape), err


def mlp_ln(x, w1, b1, w2, b2, gamma, beta):
    """LayerNorm(MLP(x)), eps 1e-6 — K3."""
    if x.device.type == "cpu":
        return mlp_ln_plain(x, w1, b1, w2, b2, gamma, beta)
    out, err = _launch(x, w1, b1, w2, b2, gamma, beta, False, _LN_EPS,
                       "mlp_ln")
    mlp_ln.launches += 1
    _build.check(err, "mlp_ln")
    return out


def mlp_ln_res(x, w1, b1, w2, b2, gamma, beta):
    """LayerNorm(x + MLP(x)), eps 1e-5 — K4, inference form (no dropout)."""
    if x.device.type == "cpu":
        return mlp_ln_plain(x, w1, b1, w2, b2, gamma, beta, residual=True,
                            eps=_BERT_LN_EPS)
    out, err = _launch(x, w1, b1, w2, b2, gamma, beta, True, _BERT_LN_EPS,
                       "mlp_ln_res")
    mlp_ln_res.launches += 1
    _build.check(err, "mlp_ln_res")
    return out


mlp_ln.launches = 0
mlp_ln_res.launches = 0
