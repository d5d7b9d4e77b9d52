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

CUDA tensors run ``csrc/mlp_ln.cu`` and ``csrc/fused_dense.cu`` (bf16 only;
anything else raises); CPU tensors run the plain versions. The wrappers
never fall back from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mvuld_tpu_torch.ops import _build

_LN_EPS = 1e-6
_BERT_LN_EPS = 1e-5   # HF RobertaConfig.layer_norm_eps
_HIDDEN_CHUNK = 128   # the kernel's hidden chunk; Hd must be a multiple
_MAX_C = 1024         # the kernel's fp32 row-tile accumulator bound


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


def _lib(name):
    fn = getattr(_build.load("mlp_ln"), name)
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] * 8 + [F, P] + [I] * 4 + [F, P]
                       if name == "mlp_ln_fwd" else
                       [P] * 3 + [F] + [P] * 14 + [I] * 4 + [F]
                       + [I] * 3 + [P])
        fn.restype = ctypes.c_int
    return fn


def _aligned(t):
    """A contiguous tensor whose data starts on 32 bytes (wmma loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 32 == 0 else t.clone()


def _check_kernel(x, w1, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    C, Hd = w1.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what} kernel: x dtype {x.dtype} (want bfloat16)")
    if C % 16 or C > _MAX_C or Hd % _HIDDEN_CHUNK:
        raise ValueError(f"{what} kernel: C={C} must be a multiple of 16 and "
                         f"≤ {_MAX_C}, Hd={Hd} a multiple of {_HIDDEN_CHUNK}")


def _kernel_operands(x, w1, b1, w2, b2, gamma, mask, keep_prob):
    dev = x.device
    C = w1.shape[0]
    bf = lambda w: _aligned(w.to(device=dev, dtype=torch.bfloat16))  # noqa: E731
    f32 = lambda v: v.to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    m2 = (None if mask is None or keep_prob >= 1.0
          else bf(mask.reshape(-1, C)))
    return (_aligned(x.reshape(-1, C)), bf(w1), f32(b1), bf(w2), f32(b2),
            f32(gamma), m2)


def _forward(x, w1, b1, w2, b2, gamma, beta, residual, eps, mask, keep_prob,
             counter):
    _check_shapes(x, w1, b1, w2, b2, gamma, beta)
    if x.device.type == "cpu":
        return mlp_ln_plain(x, w1, b1, w2, b2, gamma, beta, residual, eps,
                            mask, keep_prob)
    what = counter.__name__
    _check_kernel(x, w1, what)
    C, Hd = w1.shape
    x2, w1b, b1f, w2b, b2f, gf, m2 = _kernel_operands(
        x, w1, b1, w2, b2, gamma, mask, keep_prob)
    bt = beta.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x2)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib("mlp_ln_fwd")(
        x2.data_ptr(), w1b.data_ptr(), b1f.data_ptr(), w2b.data_ptr(),
        b2f.data_ptr(), gf.data_ptr(), bt.data_ptr(),
        0 if m2 is None else m2.data_ptr(), float(keep_prob), out.data_ptr(),
        x2.shape[0], C, Hd, int(residual), eps, stream)
    counter.launches += 1
    _build.check(err, what)
    return out.reshape(x.shape)


def _split_rows(Mp: int, tiles: int, sms: int):
    """Row groups of the weight-gradient contraction: enough (tile, group)
    blocks to fill the card, groups of at least 512 rows."""
    S = max(1, min(math.ceil(2 * sms / tiles), Mp // 512))
    rows = math.ceil(Mp / S / 16) * 16
    return math.ceil(Mp / rows), rows


def _backward(x, dy, w1, b1, w2, b2, gamma, residual, eps, mask, keep_prob,
              counter):
    if x.device.type == "cpu":
        return mlp_ln_bwd_plain(x, dy, w1, b1, w2, b2, gamma, residual, eps,
                                mask, keep_prob)
    what = counter.__name__
    _check_kernel(x, w1, what)
    dev = x.device
    C, Hd = w1.shape
    x2, w1b, b1f, w2b, b2f, gf, m2 = _kernel_operands(
        x, w1, b1, w2, b2, gamma, mask, keep_prob)
    M = x2.shape[0]
    Mp = -(-M // 16) * 16
    if Mp != M:
        x2 = torch.cat([x2, x2.new_zeros(Mp - M, C)])
    dy2 = dy.reshape(-1, C).to(torch.bfloat16).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = min(Mp // 16, 2 * sms)
    S, rows = _split_rows(Mp, -(-C // 64) * -(-Hd // 64), sms)
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    dx = torch.empty((M, C), **bf16)
    dw1, dw2 = torch.empty((C, Hd), **f32), torch.empty((Hd, C), **f32)
    dvec = torch.empty((Hd + 3 * C,), **f32)
    dzb = torch.empty((Mp, C), **bf16)
    hb, dhb = torch.empty((Mp, Hd), **bf16), torch.empty((Mp, Hd), **bf16)
    col_part = torch.empty((G, Hd + 3 * C), **f32)
    wpart = torch.empty((S if S > 1 else 0, C * Hd), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib("mlp_ln_bwd")(
        x2.data_ptr(), dy2.data_ptr(), 0 if m2 is None else m2.data_ptr(),
        float(keep_prob), w1b.data_ptr(), b1f.data_ptr(), w2b.data_ptr(),
        b2f.data_ptr(), gf.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
        dw2.data_ptr(), dvec.data_ptr(), dzb.data_ptr(), hb.data_ptr(),
        dhb.data_ptr(), col_part.data_ptr(), wpart.data_ptr(), M, C, Hd,
        int(residual), eps, G, S, rows, stream)
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

_DENSE_TM = 16                 # the kernels' row tile
_SMEM_LIMIT = 227 * 1024       # shared memory one block may use on sm_90


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


def dense_bwd_plain(x, w, b, gamma, dy, act: str = "gelu", ln: bool = False):
    """Plain PyTorch version of K6b on x [M, K], dy [M, N]: (dz [M, N] in
    x's dtype, vecs [1 or 3, N] fp32: db, and dγ, dβ with ``ln``)."""
    dt = x.dtype
    z = x.float() @ w.to(dt).float() + b.float()
    a = gelu(z) if act == "gelu" else z
    d = dy.to(dt).float()
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
    return d.to(dt), torch.stack([d.sum(0)] + vecs)


def _dense_lib(name):
    fn = getattr(_build.load("fused_dense"), name)
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] * 6 + [I] * 5 + [F, P] if name == "dense_act_ln_fwd"
                       else [P] * 8 + [I] * 5 + [F, I, P])
        fn.restype = ctypes.c_int
    return fn


def _check_dense_kernel(x, K, N, ln, what, backward):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what} kernel: x dtype {x.dtype} (want bfloat16)")
    if K % 16 or N % 16:
        raise ValueError(f"{what} kernel: K={K} and N={N} must be multiples "
                         f"of 16")
    tm = _DENSE_TM
    smem = tm * K * 2 + tm * 128 * 4
    if ln or backward:
        smem += tm * N * 4
    if backward:
        smem += (3 if ln else 1) * N * 4 + tm * 16
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what} kernel: K={K}, N={N} need {smem} bytes of "
                         f"shared memory (at most {_SMEM_LIMIT})")


def _dense_operands(x, w, b, gamma, beta, ln):
    dev = x.device
    f32 = lambda v: v.to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    wb = _aligned(w.to(device=dev, dtype=torch.bfloat16))
    g = f32(gamma) if ln else f32(b)       # unread without LN
    bt = f32(beta) if ln else g
    return _aligned(x), wb, f32(b), g, bt


def dense_fwd(x, w, b, gamma=None, beta=None, act: str = "gelu",
              ln: bool = False):
    """K6 on x [M, K]: act(x@W + b), then LN·γ + β with ``ln``; [M, N] in
    x's dtype. CUDA tensors run ``csrc/fused_dense.cu`` (bf16), CPU tensors
    ``dense_fwd_plain``."""
    _check_dense(x, w, b, gamma, beta, ln)
    if x.device.type == "cpu":
        return dense_fwd_plain(x, w, b, gamma, beta, act, ln)
    (M, K), N = x.shape, w.shape[1]
    _check_dense_kernel(x, K, N, ln, "dense_fwd", False)
    x2, wb, bf, gf, btf = _dense_operands(x, w, b, gamma, beta, ln)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _dense_lib("dense_act_ln_fwd")(
        x2.data_ptr(), wb.data_ptr(), bf.data_ptr(), gf.data_ptr(),
        btf.data_ptr(), out.data_ptr(), M, K, N, int(act == "gelu"), int(ln),
        _LN_EPS, stream)
    dense_fwd.launches += 1
    _build.check(err, "dense_fwd")
    return out


def dense_bwd(x, w, b, gamma, dy, act: str = "gelu", ln: bool = False):
    """K6b on x [M, K], dy [M, N]: (dz [M, N] in x's dtype, vecs [1 or 3, N]
    fp32: db, and dγ, dβ with ``ln``). CUDA tensors run
    ``csrc/fused_dense.cu`` (bf16), CPU tensors ``dense_bwd_plain``."""
    _check_dense(x, w, b, gamma, gamma, ln)
    if x.device.type == "cpu":
        return dense_bwd_plain(x, w, b, gamma, dy, act, ln)
    (M, K), N = x.shape, w.shape[1]
    _check_dense_kernel(x, K, N, ln, "dense_bwd", True)
    dev = x.device
    x2, wb, bf, gf, _ = _dense_operands(x, w, b, gamma, gamma, ln)
    dy2 = dy.reshape(M, N).to(torch.bfloat16).contiguous()
    nvec = 3 if ln else 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = min(-(-M // _DENSE_TM), 2 * sms)
    dz = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    vecs = torch.empty((nvec, N), dtype=torch.float32, device=dev)
    col_part = torch.empty((G, nvec * N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _dense_lib("dense_act_ln_bwd")(
        x2.data_ptr(), wb.data_ptr(), bf.data_ptr(), gf.data_ptr(),
        dy2.data_ptr(), dz.data_ptr(), vecs.data_ptr(), col_part.data_ptr(),
        M, K, N, int(act == "gelu"), int(ln), _LN_EPS, G, stream)
    dense_bwd.launches += 1
    _build.check(err, "dense_bwd")
    return dz, vecs


dense_fwd.launches = 0
dense_bwd.launches = 0


def _mm_f32(a, b):
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
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
