"""Fused dense layers: the K3 (``mlp_ln``) and K4 (``mlp_ln_res``) MLP +
LayerNorm kernels and their backward kernels K3b and K4b, and the K6 /
K6b dense-with-epilogue kernels behind ``dense_act`` / ``dense_ln``.

Counterparts of ``mvuld_tpu/ops/fused_dense.py`` ``mlp_ln`` (SwinBlockV2's
post-norm MLP half, LayerNorm eps 1e-6) and ``mlp_ln_res`` (the RoBERTa
layer's residual MLP half with its dropout keep-mask, eps 1e-5), both
``custom_vjp`` ops there and ``torch.autograd.Function``s here:

  mlp_ln:      y = LN(GELU(x@W1 + b1)@W2 + b2)·γ + β
  mlp_ln_res:  y = LN(x + (GELU(x@W1 + b1)@W2 + b2)·mask/keep)·γ + β

Weights are in the JAX layout (W1 ``[C, Hd]``, W2 ``[Hd, C]``) and are
cast to x's dtype before the products, which accumulate in fp32; the hidden
activation is rounded to x's dtype before the second product, as the Pallas
kernel does. ``mask`` is a {0,1} keep-mask of x's shape and dtype, read
only when keep_prob < 1. The backward matches the Pallas casts: dy is cast
to x's dtype, and dz and dh are rounded to it before their products. GELU
is the exact erf form; the Pallas kernels take a polynomial erf
(|err| ≤ 1.5e-7, a Mosaic workaround) and differentiate it, so their GELU
gradient differs from the exact one by about 1e-6.

``dense_act`` / ``dense_ln`` are the counterparts of the JAX package's
(one dense layer, its epilogue fused):

  dense_act:   y = act(x@W + b)
  dense_ln:    y = LN(act(x@W + b))·γ + β        (eps 1e-6)

with W cast to x's dtype, z = x@W + b summed in fp32, GELU the exact erf
form and y in x's dtype. Their backward recomputes z (K6b) and returns dz
in x's dtype with the fp32 column sums db (dγ, dβ); dx = dz·Wᵀ and
dW = xᵀ·dz are plain products with fp32 sums, as the JAX package leaves
them to XLA with ``preferred_element_type=f32``.

CUDA tensors run ``csrc/mlp_ln.cu`` and ``csrc/fused_dense.cu`` (bf16 or
fp32; anything else raises); CPU tensors run the plain versions. The
wrappers never fall back from one to the other. With fp32 x the kernels
split each fp32 operand into two bf16 terms and add three tensor-core
products per product (hi·hi + hi·lo + lo·hi, fp32 sums, about 2⁻¹⁷ of each
product, no TF32); ``_mlp_ln_split`` and ``_dense_split`` repeat their
arithmetic in plain PyTorch for the CPU tests, and ``dense_envelope`` states
the shapes K6/K6b take.
"""

from __future__ import annotations

import ctypes

import torch

from mvuld_tpu_torch.ops import _build

_LN_EPS = 1e-6
_BERT_LN_EPS = 1e-5   # HF RobertaConfig.layer_norm_eps
_HIDDEN_CHUNK = 128   # Hd must be a multiple (the kernels' column tile)
_MAX_C = 1024         # the LayerNorm row pass holds a row in one warp


def gelu(z):
    """Exact-erf GELU (nn.gelu(approximate=False) / torch nn.GELU())."""
    return 0.5 * z * (1.0 + torch.erf(z * 0.7071067811865476))


def gelu_grad(z):
    """d GELU / dz of the exact-erf form."""
    return (0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
            + z * 0.3989422804014327 * torch.exp(-0.5 * z * z))


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


def _scaled_mask(mask, keep_prob: float, C: int):
    """mask/keep as fp32 [M, C], or None when the mask is unread."""
    if mask is None or keep_prob >= 1.0:
        return None
    return mask.reshape(-1, C).float() / keep_prob


def mlp_ln_plain(x, w1, b1, w2, b2, gamma, beta, residual: bool = False,
                 eps: float = _LN_EPS, mask=None, keep_prob: float = 1.0):
    """Plain PyTorch version of K3 (``residual=False``) and K4."""
    _check_shapes(x, w1, b1, w2, b2, gamma, beta)
    dt = x.dtype
    C = x.shape[-1]
    xf = x.reshape(-1, C).float()
    h = gelu(xf @ w1.to(dt).float() + b1.float())
    z = h.to(dt).float() @ w2.to(dt).float() + b2.float()
    sm = _scaled_mask(mask, keep_prob, C)
    if sm is not None:
        z = z * sm
    if residual:
        z = z + xf
    mu = z.mean(-1, keepdim=True)
    zc = z - mu
    var = (zc * zc).mean(-1, keepdim=True)
    y = zc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(dt).reshape(x.shape)


def mlp_ln_bwd_plain(x, dy, w1, b1, w2, b2, gamma, residual: bool = False,
                     eps: float = _LN_EPS, mask=None, keep_prob: float = 1.0):
    """Plain PyTorch version of K3b (``residual=False``) and K4b: returns
    (dx in x's dtype, dW1, db1, dW2, db2, dγ, dβ in fp32)."""
    dt = x.dtype
    C, Hd = w1.shape
    xf = x.reshape(-1, C).float()
    w1b, w2b = w1.to(dt).float(), w2.to(dt).float()
    h_pre = xf @ w1b + b1.float()
    hb = gelu(h_pre).to(dt).float()
    z = hb @ w2b + b2.float()
    sm = _scaled_mask(mask, keep_prob, C)
    if sm is not None:
        z = z * sm
    if residual:
        z = z + xf
    zc = z - z.mean(-1, keepdim=True)
    rstd = torch.rsqrt((zc * zc).mean(-1, keepdim=True) + eps)
    zhat = zc * rstd
    dyf = dy.reshape(-1, C).to(dt).float()
    dgamma, dbeta = (dyf * zhat).sum(0), dyf.sum(0)
    dyg = dyf * gamma.float()
    dz = (dyg - dyg.mean(-1, keepdim=True)
          - zhat * (dyg * zhat).mean(-1, keepdim=True)) * rstd
    dzm = dz if sm is None else dz * sm
    dzb = dzm.to(dt).float()
    dh_pre = (dzb @ w2b.t()) * gelu_grad(h_pre)
    dhb = dh_pre.to(dt).float()
    dx = dhb @ w1b.t()
    if residual:
        dx = dx + dz
    return (dx.to(dt).reshape(x.shape), xf.t() @ dhb, dh_pre.sum(0),
            hb.t() @ dzb, dzm.sum(0), dgamma, dbeta)


def _terms(x, parts: int):
    """fp32 x as ``parts`` bf16-valued fp32 terms: hi = bf16(x), then lo =
    bf16(x − hi), the lo term taken from the fp32 value."""
    out, rest = [], x
    for _ in range(parts):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def _mm_terms(a, b):
    """Σ a_i @ b_j over the term pairs with i + j ≤ 1 (hi·hi + hi·lo +
    lo·hi; one product for bf16 operands), in fp32: the kernels' products."""
    total = a[0] @ b[0]
    if len(a) > 1:
        total = total + a[0] @ b[1] + a[1] @ b[0]
    return total


def _mlp_ln_split(x, w1, b1, w2, b2, gamma, beta, residual: bool = False,
                  eps: float = _LN_EPS, mask=None, keep_prob: float = 1.0,
                  dy=None):
    """``csrc/mlp_ln.cu``'s arithmetic in plain PyTorch, for the CPU tests
    (nothing on the main path calls it): every product operand in x's type
    as bf16 terms (two for fp32, ``_terms``) and three products for one
    (``_mm_terms``); h, dz·mask/keep and dh_pre rounded to x's type (fp32:
    split into terms) before their products as the passes write them; z,
    h_pre and the column sums fp32. Returns y in x's type, or with ``dy``
    (y, (dx, dW1, db1, dW2, db2, dγ, dβ)) as ``mlp_ln_bwd_plain``."""
    dt = x.dtype
    parts = 2 if dt == torch.float32 else 1
    C = w1.shape[0]
    tr = lambda ts: [t.t() for t in ts]  # noqa: E731
    xf = x.reshape(-1, C).float()
    xt = _terms(xf, parts)
    w1t = _terms(w1.to(dt).float(), parts)
    w2t = _terms(w2.to(dt).float(), parts)
    h_pre = _mm_terms(xt, w1t) + b1.float()
    ht = _terms(gelu(h_pre), parts)
    z = _mm_terms(ht, w2t) + b2.float()
    sm = _scaled_mask(mask, keep_prob, C)
    if sm is not None:
        z = z * sm
    if residual:
        z = z + xf
    zc = z - z.mean(-1, keepdim=True)
    rstd = torch.rsqrt((zc * zc).mean(-1, keepdim=True) + eps)
    zhat = zc * rstd
    y = (zhat * gamma.float() + beta.float()).to(dt).reshape(x.shape)
    if dy is None:
        return y
    dyf = dy.reshape(-1, C).to(dt).float()
    dyg = dyf * gamma.float()
    dz = (dyg - dyg.mean(-1, keepdim=True)
          - zhat * (dyg * zhat).mean(-1, keepdim=True)) * rstd
    dzm = dz if sm is None else dz * sm
    dzt = _terms(dzm, parts)
    dh_pre = _mm_terms(dzt, tr(w2t)) * gelu_grad(h_pre)
    dht = _terms(dh_pre, parts)
    dx = _mm_terms(dht, tr(w1t))
    if residual:
        dx = dx + dz
    return y, (dx.to(dt).reshape(x.shape), _mm_terms(tr(xt), dht),
               dh_pre.sum(0), _mm_terms(tr(ht), dzt), dzm.sum(0),
               (dyf * zhat).sum(0), dyf.sum(0))


def _lib(name):
    fn = getattr(_build.load("mlp_ln"), name)
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = {
            "mlp_ln_work_bytes": [I] * 6,
            "mlp_ln_fwd": [P] * 8 + [F, P] + [I] * 4 + [F, I, P, I, P],
            "mlp_ln_bwd": [P] * 3 + [F] + [P] * 9 + [I] * 4 + [F, I, P, I, P],
        }[name]
        fn.restype = (ctypes.c_size_t if name == "mlp_ln_work_bytes"
                      else ctypes.c_int)
    return fn


def _aligned(t):
    """A contiguous tensor whose data starts on 32 bytes (the kernels load
    16 and 32 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 32 == 0 else t.clone()


_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_kernel(x, w1, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    C, Hd = w1.shape
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what} kernel: x dtype {x.dtype} (want bfloat16 "
                         f"or float32)")
    if C % 16 or C > _MAX_C or Hd % _HIDDEN_CHUNK:
        raise ValueError(f"{what} kernel: C={C} must be a multiple of 16 and "
                         f"≤ {_MAX_C}, Hd={Hd} a multiple of {_HIDDEN_CHUNK}")


def _kernel_operands(x, w1, b1, w2, b2, gamma, mask, keep_prob):
    """x and the weights in x's type (the kernels split fp32 ones into bf16
    terms themselves), the vectors fp32, the mask bf16 ({0,1} is exact)."""
    dev, dt = x.device, x.dtype
    C = w1.shape[0]
    w = lambda t: _aligned(t.to(device=dev, dtype=dt))  # noqa: E731
    f32 = lambda v: v.to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    m2 = (None if mask is None or keep_prob >= 1.0 else
          _aligned(mask.reshape(-1, C).to(device=dev, dtype=torch.bfloat16)))
    return (_aligned(x.reshape(-1, C)), w(w1), f32(b1), w(w2), f32(b2),
            f32(gamma), m2)


def _work(M, C, Hd, fp32: bool, backward: bool, dev):
    """The launch's scratch (hidden, z, ...; ``mlp_ln_work_bytes``) and the
    card's multiprocessor count, which sets the backward's row groups."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = _lib("mlp_ln_work_bytes")(M, C, Hd, int(fp32), int(backward), sms)
    return torch.empty(n, dtype=torch.uint8, device=dev), sms


def _forward(x, w1, b1, w2, b2, gamma, beta, residual, eps, mask, keep_prob,
             counter):
    _check_shapes(x, w1, b1, w2, b2, gamma, beta)
    if x.device.type == "cpu":
        return mlp_ln_plain(x, w1, b1, w2, b2, gamma, beta, residual, eps,
                            mask, keep_prob)
    what = counter.__name__
    _check_kernel(x, w1, what)
    C, Hd = w1.shape
    x2, w1k, b1f, w2k, b2f, gf, m2 = _kernel_operands(
        x, w1, b1, w2, b2, gamma, mask, keep_prob)
    bt = beta.to(device=x.device, dtype=torch.float32).contiguous()
    M = x2.shape[0]
    fp32 = x.dtype == torch.float32
    work, sms = _work(M, C, Hd, fp32, False, x.device)
    out = torch.empty_like(x2)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib("mlp_ln_fwd")(
        x2.data_ptr(), w1k.data_ptr(), b1f.data_ptr(), w2k.data_ptr(),
        b2f.data_ptr(), gf.data_ptr(), bt.data_ptr(),
        0 if m2 is None else m2.data_ptr(), float(keep_prob), out.data_ptr(),
        M, C, Hd, int(residual), eps, int(fp32), work.data_ptr(), sms, stream)
    counter.launches += 1
    _build.check(err, what)
    return out.reshape(x.shape)


def _backward(x, dy, w1, b1, w2, b2, gamma, residual, eps, mask, keep_prob,
              counter):
    if x.device.type == "cpu":
        return mlp_ln_bwd_plain(x, dy, w1, b1, w2, b2, gamma, residual, eps,
                                mask, keep_prob)
    what = counter.__name__
    _check_kernel(x, w1, what)
    dev = x.device
    C, Hd = w1.shape
    x2, w1k, b1f, w2k, b2f, gf, m2 = _kernel_operands(
        x, w1, b1, w2, b2, gamma, mask, keep_prob)
    M = x2.shape[0]
    fp32 = x.dtype == torch.float32
    dy2 = _aligned(dy.reshape(-1, C).to(x.dtype))
    work, sms = _work(M, C, Hd, fp32, True, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x2)
    dw1, dw2 = torch.empty((C, Hd), **f32), torch.empty((Hd, C), **f32)
    dvec = torch.empty((Hd + 3 * C,), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib("mlp_ln_bwd")(
        x2.data_ptr(), dy2.data_ptr(), 0 if m2 is None else m2.data_ptr(),
        float(keep_prob), w1k.data_ptr(), b1f.data_ptr(), w2k.data_ptr(),
        b2f.data_ptr(), gf.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
        dw2.data_ptr(), dvec.data_ptr(), M, C, Hd, int(residual), eps,
        int(fp32), work.data_ptr(), sms, stream)
    counter.launches += 1
    _build.check(err, what)
    db1, db2, dgamma, dbeta = dvec.split([Hd, C, C, C])
    return dx.reshape(x.shape), dw1, db1, dw2, db2, dgamma, dbeta


def mlp_ln_bwd(x, dy, w1, b1, w2, b2, gamma):
    """K3b: (dx, dW1, db1, dW2, db2, dγ, dβ) of ``mlp_ln``."""
    return _backward(x, dy, w1, b1, w2, b2, gamma, False, _LN_EPS, None, 1.0,
                     mlp_ln_bwd)


def mlp_ln_res_bwd(x, dy, w1, b1, w2, b2, gamma, mask=None,
                   keep_prob: float = 1.0):
    """K4b: (dx, dW1, db1, dW2, db2, dγ, dβ) of ``mlp_ln_res``."""
    return _backward(x, dy, w1, b1, w2, b2, gamma, True, _BERT_LN_EPS, mask,
                     keep_prob, mlp_ln_res_bwd)


class _MlpLN(torch.autograd.Function):
    """K3/K4 forward, K3b/K4b backward (recomputing h and z from x)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta, mask, keep_prob,
                residual):
        fwd = mlp_ln_res if residual else mlp_ln
        eps = _BERT_LN_EPS if residual else _LN_EPS
        y = _forward(x, w1, b1, w2, b2, gamma, beta, residual, eps, mask,
                     keep_prob, fwd)
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma, mask)
        ctx.keep_prob, ctx.residual = keep_prob, residual
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2, gamma, mask = ctx.saved_tensors
        if ctx.residual:
            grads = mlp_ln_res_bwd(x, dy, w1, b1, w2, b2, gamma, mask,
                                   ctx.keep_prob)
        else:
            grads = mlp_ln_bwd(x, dy, w1, b1, w2, b2, gamma)
        return (*grads, None, None, None)


def mlp_ln(x, w1, b1, w2, b2, gamma, beta):
    """LayerNorm(MLP(x)), eps 1e-6 — K3, with K3b as its gradient."""
    return _MlpLN.apply(x, w1, b1, w2, b2, gamma, beta, None, 1.0, False)


def mlp_ln_res(x, w1, b1, w2, b2, gamma, beta, mask=None,
               keep_prob: float = 1.0):
    """LayerNorm(x + MLP(x)·mask/keep), eps 1e-5 — K4, with K4b as its
    gradient. ``mask`` ({0,1}, x's shape) is read only when keep_prob < 1."""
    return _MlpLN.apply(x, w1, b1, w2, b2, gamma, beta, mask,
                        float(keep_prob), True)


mlp_ln.launches = 0
mlp_ln_res.launches = 0
mlp_ln_bwd.launches = 0
mlp_ln_res_bwd.launches = 0


# ------------------------------------------------------- K6 / K6b: dense_*

# the GEMM core's grid holds at most 65535 row tiles of 128 rows
_DENSE_MAX_M = 65535 * 128


def _check_dense(x, w, b, gamma, beta, ln: bool):
    K, N = w.shape
    want = {"x": (x.shape[-1], K), "b": (tuple(b.shape), (N,))}
    if ln:
        want.update(gamma=(tuple(gamma.shape), (N,)),
                    beta=(tuple(beta.shape), (N,)))
    bad = {k: got for k, (got, exp) in want.items() if got != exp}
    if bad:
        raise ValueError(f"fused dense: shapes {bad} do not fit w "
                         f"[K={K}, N={N}]")


def dense_envelope(M: int, K: int, N: int, dtype) -> None:
    """The shapes and types K6/K6b take, checked before any launch: x
    [M, K] @ W [K, N] in bf16 or fp32, K and N positive multiples of 16 (the
    GEMM core copies 16 bytes at a time), 1 ≤ M ≤ 65535·128 (its grid of
    row tiles). Ragged M, K and N are zero-filled by the core's copies, and
    the LayerNorm row passes walk a row of any length, so LN sets no limit.
    Raises ValueError; a pure function of its arguments."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"dense kernels: x dtype {dtype} (want bfloat16 or "
                         f"float32)")
    if K < 16 or N < 16 or K % 16 or N % 16:
        raise ValueError(f"dense kernels: K={K} and N={N} must be positive "
                         f"multiples of 16")
    if not 1 <= M <= _DENSE_MAX_M:
        raise ValueError(f"dense kernels: M={M} rows (want 1 to "
                         f"{_DENSE_MAX_M})")


def _epilogue(z, act: str, ln: bool, gamma, beta):
    a = gelu(z) if act == "gelu" else z
    if not ln:
        return a
    zc = a - a.mean(-1, keepdim=True)
    var = (zc * zc).mean(-1, keepdim=True)
    return zc * torch.rsqrt(var + _LN_EPS) * gamma.float() + beta.float()


def dense_fwd_plain(x, w, b, gamma=None, beta=None, act: str = "gelu",
                    ln: bool = False):
    """Plain PyTorch version of K6 on x [M, K]: [M, N] in x's dtype."""
    z = x.float() @ w.to(x.dtype).float() + b.float()
    return _epilogue(z, act, ln, gamma, beta).to(x.dtype)


def _dense_bwd_vecs(z, a, d, gamma, act: str, ln: bool):
    """dz (fp32) and the column sums [db (, dγ, dβ)] from z, a = act(z)
    and the output gradient d (fp32)."""
    vecs = []
    if ln:
        zc = a - a.mean(-1, keepdim=True)
        rstd = torch.rsqrt((zc * zc).mean(-1, keepdim=True) + _LN_EPS)
        zhat = zc * rstd
        vecs = [(d * zhat).sum(0), d.sum(0)]
        dg = d * gamma.float()
        d = (dg - dg.mean(-1, keepdim=True)
             - zhat * (dg * zhat).mean(-1, keepdim=True)) * rstd
    if act == "gelu":
        d = d * gelu_grad(z)
    return d, [d.sum(0)] + vecs


def dense_bwd_plain(x, w, b, gamma, dy, act: str = "gelu", ln: bool = False):
    """Plain PyTorch version of K6b on x [M, K], dy [M, N]: (dz [M, N] in
    x's dtype, vecs [1 or 3, N] fp32: db, and dγ, dβ with ``ln``)."""
    dt = x.dtype
    z = x.float() @ w.to(dt).float() + b.float()
    a = gelu(z) if act == "gelu" else z
    d, vecs = _dense_bwd_vecs(z, a, dy.to(dt).float(), gamma, act, ln)
    return d.to(dt), torch.stack(vecs)


def _dense_split(x, w, b, gamma=None, beta=None, act: str = "gelu",
                 ln: bool = False, dy=None):
    """``csrc/fused_dense.cu``'s arithmetic in plain PyTorch, for the CPU
    tests (nothing on the main path calls it): x and W in x's type as bf16
    terms (two for fp32, ``_terms``) and three products for one
    (``_mm_terms``); z, the LayerNorm and the column sums fp32; dz rounded
    to x's type as the passes write it, then dx = dz·Wᵀ and dW = xᵀ·dz with
    fp32 sums as ``_FusedDense.backward`` takes them. Returns y in x's type,
    or with ``dy`` (y, (dx, dW, db[, dγ, dβ]))."""
    dt = x.dtype
    parts = 2 if dt == torch.float32 else 1
    xf, wb = x.float(), w.to(dt).float()
    z = _mm_terms(_terms(xf, parts), _terms(wb, parts)) + b.float()
    a = gelu(z) if act == "gelu" else z
    y = _epilogue(a, "none", ln, gamma, beta).to(dt)
    if dy is None:
        return y
    d, vecs = _dense_bwd_vecs(z, a, dy.to(dt).float(), gamma, act, ln)
    dzb = d.to(dt).float()
    return y, ((dzb @ wb.t()).to(dt), xf.t() @ dzb, *vecs)


def _dense_lib(name):
    fn = getattr(_build.load("fused_dense"), name)
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = {
            "dense_work_bytes": [I] * 8,
            "dense_act_ln_fwd": [P] * 6 + [I] * 5 + [F, I, P, P],
            "dense_act_ln_bwd": [P] * 7 + [I] * 5 + [F, I, P, I, P],
        }[name]
        fn.restype = (ctypes.c_size_t if name == "dense_work_bytes"
                      else ctypes.c_int)
    return fn


def _dense_launch_args(x, w, b, gamma, beta, act, ln, what, backward):
    """Check the device and the envelope, then x and W in x's type, the
    vectors fp32, the launch's scratch (``dense_work_bytes``: the LN
    scratch, the column partials, fp32 x's split operands; freed when the
    call returns) and the card's multiprocessor count."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    (M, K), N = x.shape, w.shape[1]
    dense_envelope(M, K, N, x.dtype)
    dev = x.device
    f32 = lambda v: v.to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    bf = f32(b)
    g = f32(gamma) if ln else bf       # unread without LN
    bt = f32(beta) if ln and beta is not None else g
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = _dense_lib("dense_work_bytes")(
        M, K, N, int(act == "gelu"), int(ln), int(x.dtype == torch.float32),
        int(backward), sms)
    work = torch.empty(n, dtype=torch.uint8, device=dev)
    return (_aligned(x), _aligned(w.to(device=dev, dtype=x.dtype)), bf, g, bt,
            work, sms)


def dense_fwd(x, w, b, gamma=None, beta=None, act: str = "gelu",
              ln: bool = False):
    """K6 on x [M, K]: act(x@W + b), then LN·γ + β with ``ln``; [M, N] in
    x's dtype. CUDA tensors run ``csrc/fused_dense.cu`` (bf16 or fp32), CPU
    tensors ``dense_fwd_plain``."""
    _check_dense(x, w, b, gamma, beta, ln)
    if x.device.type == "cpu":
        return dense_fwd_plain(x, w, b, gamma, beta, act, ln)
    x2, wk, bf, gf, btf, work, _ = _dense_launch_args(
        x, w, b, gamma, beta, act, ln, "dense_fwd", False)
    (M, K), N = x.shape, w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _dense_lib("dense_act_ln_fwd")(
        x2.data_ptr(), wk.data_ptr(), bf.data_ptr(), gf.data_ptr(),
        btf.data_ptr(), out.data_ptr(), M, K, N, int(act == "gelu"), int(ln),
        _LN_EPS, int(x.dtype == torch.float32), work.data_ptr(), stream)
    dense_fwd.launches += 1
    _build.check(err, "dense_fwd")
    return out


def dense_bwd(x, w, b, gamma, dy, act: str = "gelu", ln: bool = False):
    """K6b on x [M, K], dy [M, N]: (dz [M, N] in x's dtype, vecs [1 or 3, N]
    fp32: db, and dγ, dβ with ``ln``). CUDA tensors run
    ``csrc/fused_dense.cu`` (bf16 or fp32), CPU tensors
    ``dense_bwd_plain``."""
    _check_dense(x, w, b, gamma, gamma, ln)
    if x.device.type == "cpu":
        return dense_bwd_plain(x, w, b, gamma, dy, act, ln)
    x2, wk, bf, gf, _, work, sms = _dense_launch_args(
        x, w, b, gamma, None, act, ln, "dense_bwd", True)
    (M, K), N = x.shape, w.shape[1]
    dev = x.device
    dy2 = _aligned(dy.reshape(M, N).to(x.dtype))
    dz = torch.empty((M, N), dtype=x.dtype, device=dev)
    vecs = torch.empty((3 if ln else 1, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _dense_lib("dense_act_ln_bwd")(
        x2.data_ptr(), wk.data_ptr(), bf.data_ptr(), gf.data_ptr(),
        dy2.data_ptr(), dz.data_ptr(), vecs.data_ptr(), M, K, N,
        int(act == "gelu"), int(ln), _LN_EPS, int(x.dtype == torch.float32),
        work.data_ptr(), sms, stream)
    dense_bwd.launches += 1
    _build.check(err, "dense_bwd")
    return dz, vecs


dense_fwd.launches = 0
dense_bwd.launches = 0


def _mm_f32(a, b):
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    if a.device.type == "cuda":
        # fp32 operands: full fp32 products, as the JAX package's XLA dots
        # at f32 precision — TF32 (10-bit mantissas) is switched off here
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a.float() @ b.float()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """``_mm_f32`` with a gradient: the cotangent is cast to each operand's
    type and multiplied the same way (fp32 sums), each gradient returned in
    its operand's type. PyTorch defines no derivative for the fp32-output
    product itself."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (_mm_f32(g.to(a.dtype), b.t()).to(a.dtype),
                _mm_f32(a.t(), g.to(b.dtype)).to(b.dtype))


def matmul_f32(a, b):
    """a @ b of 2-d bf16 (or fp32) operands with fp32 sums and an fp32
    result (``preferred_element_type=f32``): cuBLAS's bf16 product with an
    fp32 output on the card, exact fp32 products of the same values on the
    CPU; differentiable."""
    return _MatmulF32.apply(a, b)


class _FusedDense(torch.autograd.Function):
    """K6 forward, K6b backward (recomputing z from x), then dx = dz·Wᵀ and
    dW = xᵀ·dz with fp32 sums."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, act, ln):
        K, N = w.shape
        y = dense_fwd(x.reshape(-1, K), w, b, gamma, beta, act, ln)
        ctx.save_for_backward(x, w, b, gamma)
        ctx.act, ctx.ln = act, ln
        return y.reshape(*x.shape[:-1], N)

    @staticmethod
    def backward(ctx, dy):
        x, w, b, gamma = ctx.saved_tensors
        K, N = w.shape
        x2 = x.reshape(-1, K)
        dz, vecs = dense_bwd(x2, w, b, gamma, dy.reshape(-1, N).to(x.dtype),
                             ctx.act, ctx.ln)
        wb = w.to(x.dtype)
        dx = matmul_f32(dz, wb.t()).to(x.dtype).reshape(x.shape)
        dw = matmul_f32(x2.t(), dz).to(w.dtype)
        db = vecs[0].to(b.dtype)
        if not ctx.ln:
            return dx, dw, db, None, None, None, None
        return (dx, dw, db, vecs[1].to(gamma.dtype), vecs[2].to(gamma.dtype),
                None, None)


def dense_act(x, w, b, act: str = "gelu"):
    """act(x @ w + b), the activation fused into the product's epilogue
    (K6, with K6b as its gradient). x [..., K], w [K, N] fp32, b [N];
    returns [..., N] in x's dtype."""
    return _FusedDense.apply(x, w, b, None, None, act, False)


def dense_ln(x, w, b, gamma, beta, act: str = "none"):
    """LayerNorm(act(x @ w + b))·γ + β, eps 1e-6 — the SwinV2 post-norm
    pattern in one kernel (K6, with K6b as its gradient)."""
    return _FusedDense.apply(x, w, b, gamma, beta, act, True)
