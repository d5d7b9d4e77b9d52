"""The card kernels' arithmetic for K6/K6b against the JAX package, and
their shape envelope.

``csrc/fused_dense.cu`` forms z = x·W + b on the GEMM core's tensor cores
from bf16 operands: bf16 x and W as they are, fp32 ones as two bf16 terms
(hi·hi + hi·lo + lo·hi, fp32 sums), then the epilogue, the LayerNorm row
passes and the column sums in fp32, with dz rounded to x's type as the
passes write it; dx = dz·Wᵀ and dW = xᵀ·dz are fp32-summed products
outside. ``fused_dense._dense_split`` is that arithmetic in plain PyTorch;
here it is held against the Pallas ``dense_act`` / ``dense_ln`` in
interpret mode, forward and backward (``jax.vjp``), on the same numpy
inputs, at row counts below and past the core's 128-row tile (48, 130), a
depth that is not a multiple of its 64-deep k-step (K 80) and a width that
is not a multiple of its 128-column tile (N 144). Tolerances: fp32 every
value within 2e-5 of its output's largest magnitude (two-term products leave
about 2⁻¹⁷ of each product, and dW adds M rows of that through dz; the
Pallas GELU takes a polynomial erf within 1.5e-7); bf16 y within two bf16 ulps of its largest value (both
round one fp32 value, summed in another order) and each gradient within
relative L2 1e-2 (dz is rounded to bf16 before its products, and a value
near a rounding boundary may round either way).

``fused_dense.dense_envelope`` is the host's check of the shapes the
kernels take; it must accept every shape the earlier kernels (16-row tiles
with the row's fp32 z in shared memory) accepted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu.ops import fused_dense as jfd
from mvuld_tpu_torch.ops import fused_dense as fd
from jax_reference import no_persistent_compile_cache  # noqa: F401

K, N = 80, 144
NAMES = ("dx", "dw", "db", "dgamma", "dbeta")


def _inputs(M, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (sc * rng.randn(*s)).astype(np.float32)  # noqa: E731
    return (f(M, K), f(K, N, sc=K ** -0.5), f(N, sc=0.1), 1.0 + f(N, sc=0.1),
            f(N, sc=0.1)), f(M, N)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [48, 130], ids=["one_tile", "ragged_tiles"])
@pytest.mark.parametrize("act", ["gelu", "none"])
@pytest.mark.parametrize("ln", [False, True], ids=["dense_act", "dense_ln"])
def test_dense_split_products_match_pallas_interpret(ln, act, M, dtype):
    args, dy = _inputs(M, seed=21 + 2 * ln + (act == "gelu") + M)
    n = 5 if ln else 3
    args = args[:n]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if ln:
        jfn = lambda x, w, b, g, bt: jfd.dense_ln(  # noqa: E731
            x, w, b, g, bt, act=act, interpret=True)
    else:
        jfn = lambda x, w, b: jfd.dense_act(  # noqa: E731
            x, w, b, act=act, interpret=True)
    jargs = [jnp.asarray(args[0], jdt)] + [jnp.asarray(a) for a in args[1:]]
    jy, vjp = jax.vjp(jfn, *jargs)
    want = vjp(jnp.asarray(dy, jdt))

    t = [torch.tensor(args[0]).to(tdt)] + [torch.tensor(a) for a in args[1:]]
    gamma, beta = (t[3], t[4]) if ln else (None, None)
    y, got = fd._dense_split(t[0], t[1], t[2], gamma, beta, act, ln,
                             dy=torch.tensor(dy).to(tdt))
    assert y.dtype == tdt and y.shape == (M, N)
    assert got[0].dtype == tdt and got[0].shape == (M, K)
    assert len(got) == n
    jy = np.asarray(jy, np.float32)
    if dtype == "float32":
        for a, b, name in zip((y, *got), (jy, *want), ("y",) + NAMES):
            b = np.asarray(b)
            err = float(np.abs(a.numpy() - b).max())
            assert err <= 2e-5 * float(np.abs(b).max()), (name, err)
    else:
        tol = 2.0 ** -6 * float(np.abs(jy).max())
        assert float(np.abs(y.float().numpy() - jy).max()) <= tol
        for a, b, name in zip(got, want, NAMES):
            assert a.shape == b.shape, name
            assert _rel_l2(a.float().numpy(), b) <= 1e-2, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,ln", [("gelu", False), ("none", True)],
                         ids=["fc1", "fc2"])
def test_dense_split_stays_with_the_plain_version(act, ln, dtype):
    """The plain versions (which the kernels are held to on the card) and
    the kernels' split arithmetic agree: fp32 y and dz within 1e-5 of
    their largest values (the terms' 2⁻¹⁷), bf16 to two ulps; the column
    sums within relative L2 1e-5 (fp32) or 1e-3 (bf16: dz rounded)."""
    (x, w, b, gamma, beta), dy = _inputs(130, seed=8)
    t = [torch.tensor(x).to(dtype)] + [torch.tensor(a)
                                       for a in (w, b, gamma, beta)]
    g = torch.tensor(dy).to(dtype)
    y, (dx, dw, *vecs) = fd._dense_split(*t, act, ln, dy=g)
    y_p = fd.dense_fwd_plain(*t, act, ln)
    dz_p, vecs_p = fd.dense_bwd_plain(*t[:4], g, act, ln)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    assert float((y.float() - y_p.float()).abs().max()) <= \
        rel * float(y_p.float().abs().max())
    wb = t[1].to(dtype).float()
    lim = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel_l2(dx.float().numpy(), (dz_p.float() @ wb.t()).numpy()) <= lim
    assert _rel_l2(dw.numpy(), (t[0].float().t() @ dz_p.float()).numpy()) \
        <= lim
    lim = 1e-5 if dtype == torch.float32 else 1e-3
    for a, b in zip(vecs, vecs_p):
        assert _rel_l2(a.numpy(), b.numpy()) <= lim


def _parent_accepted(K, N, ln, dtype):
    """Whether the earlier K6 or K6b took (K, N): multiples of 16 whose
    16-row tile (x in one or two bf16 planes, a 16 x 128 fp32 chunk, with
    LN or in the backward the rows' fp32 z, and the backward's column sums
    and row statistics) fit 227 KB of shared memory."""
    if K % 16 or N % 16:
        return False
    terms = 2 if dtype == torch.float32 else 1
    fwd = terms * 16 * K * 2 + 16 * 128 * 4 + (16 * N * 4 if ln else 0)
    bwd = (terms * 16 * K * 2 + 16 * 128 * 4 + 16 * N * 4
           + (3 if ln else 1) * N * 4 + 16 * 16)
    return min(fwd, bwd) <= 227 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ln", [False, True])
def test_dense_envelope_accepts_every_shape_the_parent_did(ln, dtype):
    taken = 0
    for K in range(16, 7200, 16):
        for N in range(16, 7200, 48):
            if _parent_accepted(K, N, ln, dtype):
                fd.dense_envelope(50176, K, N, dtype)
                taken += 1
    assert taken > 1000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(2048, 4096), (4096, 4096), (512, 3072),
                                 (128, 16384)])
def test_dense_envelope_takes_layernorm_rows_past_4096(K, N, dtype):
    """The SwinV2 call sites (K, N in 128 … 4096) and wider, which the
    earlier kernels refused with LN: the LayerNorm row passes walk a row of
    any length."""
    fd.dense_envelope(64 * 784, K, N, dtype)
    fd.dense_envelope(1, K, N, dtype)


@pytest.mark.parametrize("K,N", [(40, 64), (64, 40), (0, 64), (64, 8),
                                 (520, 2048), (2048, 520)])
def test_dense_envelope_raises_on_k_or_n_off_the_16_grid(K, N):
    with pytest.raises(ValueError, match="multiples of 16"):
        fd.dense_envelope(64, K, N, torch.bfloat16)


@pytest.mark.parametrize("M,dtype,match", [
    (0, torch.bfloat16, "M=0"), (65535 * 128 + 1, torch.float32, "rows"),
    (64, torch.float16, "dtype")])
def test_dense_envelope_raises_on_rows_or_dtype(M, dtype, match):
    with pytest.raises(ValueError, match=match):
        fd.dense_envelope(M, 64, 64, dtype)
    fd.dense_envelope(65535 * 128, 64, 64, torch.bfloat16)
