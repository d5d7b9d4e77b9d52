"""The CUDA kernels against their plain versions, on the card.

This file holds every check of a kernel against its plain version, at any
shape or mode. ``chip_smoke.py`` runs the whole paths through the kernels
(trainers, serving, the CLIs), ``kernel_ab.py`` times the kernels of two
source trees on one card, and ``benchmark/`` measures the cells.

Each test skips when no CUDA device is present (decided in the ``dev``
fixture, never at import). On the card (``tests/conftest.py`` imports JAX,
which the GPU machine need not have):
  python -m pytest --noconftest tests/test_torch_cuda.py -q
Kernels: K1, K2, K5 (flat attention; K2 and K5 also at the model's
windows and at the batch-16 step's stage-2 windows (Bn 64, 8 heads),
twice to the bit, on misaligned views, on an underflowing row and with
``mxu_bf16``; K2's fused pass at N 784 with 4, 8 and 16 heads, 196
and 64; K2 from K1's outputs), K7/K7b (map layout), K8/K8b
(head layout with a mask operand; the three forwards K1, K7, K8 also at
the model's windows, twice to the bit, on misaligned views, with
``mxu_bf16``, K1 on an underflowing row), K3/K3b, K4/K4b (MLP + LayerNorm: bf16 and fp32 x, the model's
shapes, ragged rows, misaligned views, a backward that repeats to the
bit), K6/K6b (dense with its epilogue, bf16 and fp32, at the GEMM core's
tile edges, blockbench's shapes and a 3072-wide LayerNorm; a backward that
repeats to the bit), clip + AdamW (``fused_adamw`` to the bit against
the ``_foreach`` chain, ``sumsq`` against an fp64 sum, ``Optimizer`` on the
card through the kernels only, and within 1e-6 of optax's recorded steps), and ``make_multi_train_step``'s CUDA graph: K replayed steps of a
tiny SwinV2 through K1/K2/K3/K3b (DropPath and, in one case, dropout in
a checkpointed stage), of a tiny fusion head (BatchNorm statistics,
dropout; direct and indexed) and of a tiny e2e model (packed lines, K1-K4b,
dropout 0.1, the text layers checkpointed or not) against K eager steps
from the same state, serving's packed lines of that e2e model against
every slot encoded, of a tiny Swin-MoE (BPR, gate noise, MOE_DROP) to the
bit, and its refusal under a gloo group. Tolerances: fp32
outputs 1e-4 (both compute in fp32, another summation order; the fp32 MLP
and dense kernels from two-term bf16 products); bf16 outputs two bf16 ulps
at the largest value (both round one fp32 result to bf16).
"""

import json
import math
import os

import numpy as np
import pytest
import torch


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bf16_tol(ref):
    return 2.0 ** -6 * float(ref.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", [(16, 4, 0, 1), (32, 8, 4, 2), (18, 7, 3, 3)],
                         ids=["ws4", "ws8_shift4", "ws7_ragged_shift3"])
def test_window_attention_kernel_matches_plain(dev, geom, dtype):
    from mvuld_tpu_torch.ops.window_attention import (
        window_attention_flat, window_attention_flat_plain)
    Bn, ws, shift, nW1 = geom
    H, hd = 2, 32
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(Bn, ws * ws, 3 * H * hd, device=dev, generator=g
                      ).to(dtype)
    bias = 16 * torch.sigmoid(torch.randn(H, ws * ws, ws * ws, device=dev,
                                          generator=g))
    ls = torch.full((H,), math.log(10.0), device=dev)
    before = window_attention_flat.launches
    got = window_attention_flat(qkv, bias, ls, shift, nW1, nW1)
    want = window_attention_flat_plain(qkv, bias, ls, shift, nW1, nW1)
    assert window_attention_flat.launches == before + 1
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else _bf16_tol(want)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("name", ["mlp_ln", "mlp_ln_res"])
@pytest.mark.parametrize("M,C", [(37, 128), (100, 768)])
def test_mlp_ln_kernels_match_plain(dev, name, M, C):
    from mvuld_tpu_torch.ops import fused_dense as fd
    g = torch.Generator(device=dev).manual_seed(1)
    r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev, generator=g)  # noqa: E731
    Hd = 4 * C
    args = (r(M, C).bfloat16(), r(C, Hd, sc=C ** -0.5), r(Hd, sc=0.02),
            r(Hd, C, sc=Hd ** -0.5), r(C, sc=0.02), 1 + r(C, sc=0.1),
            r(C, sc=0.1))
    res = name == "mlp_ln_res"
    fn = getattr(fd, name)
    before = fn.launches
    got = fn(*args)
    want = fd.mlp_ln_plain(*args, residual=res, eps=1e-5 if res else 1e-6)
    assert fn.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _mlp_inputs(dev, seed, M, C, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev, generator=g)  # noqa: E731
    Hd = 4 * C
    x = r(M, C).to(dtype)
    params = (r(C, Hd, sc=C ** -0.5), r(Hd, sc=0.02), r(Hd, C, sc=Hd ** -0.5),
              r(C, sc=0.02), 1 + r(C, sc=0.1), r(C, sc=0.1))
    mask = (torch.rand(M, C, device=dev, generator=g) < 0.9).to(dtype)
    return x, params, mask, r(M, C).to(dtype)


def _mlp_run(residual, x, params, mask, dy, plain=False):
    """(y, the 7 gradients) of K3/K3b, or K4/K4b with ``mask`` at keep 0.9
    (no mask when it is None), through the kernels or the plain versions."""
    from mvuld_tpu_torch.ops import fused_dense as fd
    kw = dict(residual=residual, eps=1e-5 if residual else 1e-6)
    if residual and mask is not None:
        kw.update(mask=mask, keep_prob=0.9)
    if plain:
        return (fd.mlp_ln_plain(x, *params, **kw),
                fd.mlp_ln_bwd_plain(x, dy, *params[:5], **kw))
    extra = (mask, 0.9) if residual and mask is not None else ()
    if residual:
        return (fd.mlp_ln_res(x, *params, *extra),
                fd.mlp_ln_res_bwd(x, dy, *params[:5], *extra))
    return fd.mlp_ln(x, *params), fd.mlp_ln_bwd(x, dy, *params[:5])


def _assert_mlp_close(got, want, dtype):
    """y: fp32 within 1e-4 of its largest value, bf16 two ulps; gradients
    within relative L2 1e-4 (fp32: two-term products) or 1e-2 (bf16: dz and
    dh_pre rounded before their products, a boundary value either way)."""
    (y, grads), (y_p, grads_p) = got, want
    assert y.dtype == dtype and grads[0].dtype == dtype
    tol = (1e-4 * float(y_p.float().abs().max()) if dtype == torch.float32
           else _bf16_tol(y_p))
    assert float((y.float() - y_p.float()).abs().max()) <= tol
    lim = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b in zip(grads, grads_p):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel_l2(a, b) <= lim


@pytest.mark.parametrize("residual", [False, True], ids=["k3", "k4_mask"])
@pytest.mark.parametrize("M,C", [(37, 128), (300, 768)])
def test_mlp_ln_kernels_take_fp32(dev, residual, M, C):
    """fp32 x launches the kernels (two bf16 terms per operand, no TF32)
    and matches the fp32 plain versions at the fp32 tolerances."""
    from mvuld_tpu_torch.ops import fused_dense as fd
    x, params, mask, dy = _mlp_inputs(dev, 40, M, C, torch.float32)
    fwd, bwd = ((fd.mlp_ln_res, fd.mlp_ln_res_bwd) if residual
                else (fd.mlp_ln, fd.mlp_ln_bwd))
    f0, b0 = fwd.launches, bwd.launches
    got = _mlp_run(residual, x, params, mask, dy)
    torch.cuda.synchronize()
    assert fwd.launches == f0 + 1 and bwd.launches == b0 + 1
    _assert_mlp_close(got, _mlp_run(residual, x, params, mask, dy, plain=True),
                      torch.float32)


# (residual, M, C, masked): K3 at each SwinV2 stage's width with a ragged
# row count, K4 at the e2e model's function and line shapes
MODEL_MLP = [(False, 20071, 128, False), (False, 12545, 256, False),
             (False, 12544, 512, False), (True, 8192, 768, False),
             (True, 8192, 768, True), (True, 32768, 768, False),
             (True, 32768, 768, True)]


@pytest.mark.parametrize("residual,M,C,masked", MODEL_MLP,
                         ids=["k3_stage1", "k3_stage2", "k3_stage3",
                              "k4_function", "k4_function_mask", "k4_lines",
                              "k4_lines_mask"])
def test_mlp_kernels_at_the_model_shapes(dev, residual, M, C, masked):
    """K3/K3b and K4/K4b (with and without the keep-mask) at the model's
    shapes against the plain versions."""
    x, params, mask, dy = _mlp_inputs(dev, 41, M, C, torch.bfloat16)
    mask = mask if masked else None
    _assert_mlp_close(_mlp_run(residual, x, params, mask, dy),
                      _mlp_run(residual, x, params, mask, dy, plain=True),
                      torch.bfloat16)


@pytest.mark.parametrize("residual", [False, True], ids=["k3", "k4_mask"])
def test_mlp_kernels_take_views_off_a_16_byte_boundary(dev, residual):
    """The kernels copy 16 bytes a thread; x and dy views that start
    elsewhere are copied by the wrapper, not refused."""
    M, C = 77, 256
    x, params, mask, _ = _mlp_inputs(dev, 42, M, C, torch.bfloat16)
    flat = torch.randn(2 * M * C + 1, device=dev).to(torch.bfloat16)
    x, dy = flat[1:1 + M * C].reshape(M, C), flat[1 + M * C:].reshape(M, C)
    assert x.data_ptr() % 16 != 0 and dy.data_ptr() % 16 != 0
    _assert_mlp_close(_mlp_run(residual, x, params, mask, dy),
                      _mlp_run(residual, x, params, mask, dy, plain=True),
                      torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True], ids=["k3b", "k4b_mask"])
def test_mlp_backward_repeats_to_the_bit(dev, residual, dtype):
    """No atomics: the column and weight-gradient sums go through fixed-order
    partials, so two launches give the same bits (ragged M, several row
    groups)."""
    x, params, mask, dy = _mlp_inputs(dev, 43, 4099, 256, dtype)
    first = _mlp_run(residual, x, params, mask, dy)[1]
    again = _mlp_run(residual, x, params, mask, dy)[1]
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", [(16, 4, 0, 1), (32, 8, 4, 2), (18, 7, 3, 3)],
                         ids=["ws4", "ws8_shift4", "ws7_ragged_shift3"])
def test_window_attention_bwd_kernel_matches_plain(dev, geom, dtype):
    """K1's row sums and K2's three gradients against the plain versions:
    fp32 within 1e-4 relative L2 (another summation order; dbias sums
    every window); bf16 dqkv within 2e-2 (both round to bf16 once, the
    kernel from fp32 sums of bf16 inputs)."""
    from mvuld_tpu_torch.ops.window_attention import (
        window_attention_flat, window_attention_flat_bwd,
        window_attention_flat_bwd_plain, window_attention_flat_plain)
    Bn, ws, shift, nW1 = geom
    H, hd = 2, 32
    g = torch.Generator(device=dev).manual_seed(2)
    qkv = torch.randn(Bn, ws * ws, 3 * H * hd, device=dev, generator=g
                      ).to(dtype)
    bias = 16 * torch.sigmoid(torch.randn(H, ws * ws, ws * ws, device=dev,
                                          generator=g))
    ls = torch.full((H,), math.log(10.0), device=dev)
    args = (qkv, bias, ls, shift, nW1, nW1)
    out, r = window_attention_flat(*args[:3], *args[3:], return_rowsum=True)
    out_p, r_p = window_attention_flat_plain(*args[:3], *args[3:],
                                             return_rowsum=True)
    assert _rel_l2(r, r_p) <= 1e-5
    gout = torch.randn(out.shape, device=dev, generator=g).to(dtype)
    before = window_attention_flat_bwd.launches
    got = window_attention_flat_bwd(qkv, bias, ls, out_p, r_p, gout, shift,
                                    nW1, nW1)
    want = window_attention_flat_bwd_plain(qkv, bias, ls, out_p, r_p, gout,
                                           shift, nW1, nW1)
    torch.cuda.synchronize()
    assert window_attention_flat_bwd.launches == before + 1
    assert got[0].dtype == dtype and got[0].shape == qkv.shape
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel_l2(got[0], want[0]) <= tol
    assert _rel_l2(got[1], want[1]) <= 1e-4
    assert _rel_l2(got[2], want[2]) <= 1e-4


@pytest.mark.parametrize("name", ["mlp_ln_bwd", "mlp_ln_res_bwd"])
@pytest.mark.parametrize("M,C", [(37, 128), (100, 768), (2048, 256)])
def test_mlp_ln_bwd_kernels_match_plain(dev, name, M, C):
    """K3b/K4b (K4b with a keep-mask at 0.9) against the plain versions:
    each of the 7 gradients within 2e-2 relative L2 — both round dz and dh
    to bf16 before the products and may round a value the other way."""
    from mvuld_tpu_torch.ops import fused_dense as fd
    g = torch.Generator(device=dev).manual_seed(3)
    r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev, generator=g)  # noqa: E731
    Hd = 4 * C
    x = r(M, C).bfloat16()
    params = (r(C, Hd, sc=C ** -0.5), r(Hd, sc=0.02), r(Hd, C, sc=Hd ** -0.5),
              r(C, sc=0.02), 1 + r(C, sc=0.1))
    dy = r(M, C).bfloat16()
    res = name == "mlp_ln_res_bwd"
    extra = ()
    if res:
        mask = (torch.rand(M, C, device=dev, generator=g) < 0.9).bfloat16()
        extra = (mask, 0.9)
    fn = getattr(fd, name)
    before = fn.launches
    got = fn(x, dy, *params, *extra)
    want = fd.mlp_ln_bwd_plain(x, dy, *params, residual=res,
                               eps=1e-5 if res else 1e-6,
                               mask=extra[0] if res else None,
                               keep_prob=0.9 if res else 1.0)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got[0].dtype == torch.bfloat16 and got[0].shape == x.shape
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel_l2(a, b) <= 2e-2


def test_mlp_ln_res_mask_kernel_matches_plain(dev):
    from mvuld_tpu_torch.ops import fused_dense as fd
    g = torch.Generator(device=dev).manual_seed(4)
    r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev, generator=g)  # noqa: E731
    M, C, Hd = 64, 256, 1024
    args = (r(M, C).bfloat16(), r(C, Hd, sc=C ** -0.5), r(Hd, sc=0.02),
            r(Hd, C, sc=Hd ** -0.5), r(C, sc=0.02), 1 + r(C, sc=0.1),
            r(C, sc=0.1))
    mask = (torch.rand(M, C, device=dev, generator=g) < 0.9).bfloat16()
    got = fd.mlp_ln_res(*args, mask, 0.9)
    want = fd.mlp_ln_plain(*args, residual=True, eps=1e-5, mask=mask,
                           keep_prob=0.9)
    assert float((got.float() - want.float()).abs().max()) <= _bf16_tol(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", [(16, 4, 0, 1), (32, 8, 4, 2), (18, 7, 3, 3)],
                         ids=["ws4", "ws8_shift4", "ws7_ragged_shift3"])
def test_window_attention_bwd_v1_kernel_matches_plain_and_k2(dev, geom,
                                                             dtype):
    """K5 against its plain version (the tolerances of K2's test) and
    against K2 on the same inputs (the same function: 1e-4 fp32, 2e-2 bf16
    relative L2 for dqkv, 1e-4 fp32 and 1e-2 bf16 for dbias and dscale —
    K2 takes its row term rowsum(g·o) from the output rounded to bf16, a
    relative error up to 2^-8, where K5 sums e·dp in fp32)."""
    from mvuld_tpu_torch.ops.window_attention import (
        window_attention_flat, window_attention_flat_bwd,
        window_attention_flat_bwd_v1, window_attention_flat_bwd_v1_plain)
    Bn, ws, shift, nW1 = geom
    H, hd = 2, 32
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(Bn, ws * ws, 3 * H * hd, device=dev, generator=g
                      ).to(dtype)
    bias = 16 * torch.sigmoid(torch.randn(H, ws * ws, ws * ws, device=dev,
                                          generator=g))
    ls = torch.full((H,), math.log(10.0), device=dev)
    gout = torch.randn(Bn, ws * ws, H * hd, device=dev, generator=g).to(dtype)
    before = window_attention_flat_bwd_v1.launches
    got = window_attention_flat_bwd_v1(qkv, bias, ls, gout, shift, nW1, nW1)
    want = window_attention_flat_bwd_v1_plain(qkv, bias, ls, gout, shift,
                                              nW1, nW1)
    torch.cuda.synchronize()
    assert window_attention_flat_bwd_v1.launches == before + 1
    assert got[0].dtype == dtype and got[0].shape == qkv.shape
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel_l2(got[0], want[0]) <= tol
    assert _rel_l2(got[1], want[1]) <= 1e-4
    assert _rel_l2(got[2], want[2]) <= 1e-4
    out, r = window_attention_flat(qkv, bias, ls, shift, nW1, nW1,
                                   return_rowsum=True)
    k2 = window_attention_flat_bwd(qkv, bias, ls, out, r, gout, shift, nW1,
                                   nW1)
    assert _rel_l2(got[0], k2[0]) <= tol
    lim = 1e-4 if dtype == torch.float32 else 1e-2
    assert _rel_l2(got[1], k2[1]) <= lim and _rel_l2(got[2], k2[2]) <= lim


@pytest.mark.parametrize("act,ln", [("gelu", False), ("none", True),
                                    ("gelu", True), ("none", False)])
@pytest.mark.parametrize("M,K,N", [(37, 64, 256), (200, 256, 64)])
def test_dense_kernels_match_plain(dev, act, ln, M, K, N):
    """K6 within two bf16 ulps of its plain version; K6b's dz within
    relative L2 2e-2 (both round one fp32 value to bf16) and its column
    sums within 1e-3 relative L2 (fp32 sums in another order)."""
    from mvuld_tpu_torch.ops import fused_dense as fd
    g = torch.Generator(device=dev).manual_seed(6)
    r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev, generator=g)  # noqa: E731
    x, w, b = r(M, K).bfloat16(), r(K, N, sc=K ** -0.5), r(N, sc=0.1)
    gamma, beta, dy = 1 + r(N, sc=0.1), r(N, sc=0.1), r(M, N).bfloat16()
    f0, b0 = fd.dense_fwd.launches, fd.dense_bwd.launches
    y = fd.dense_fwd(x, w, b, gamma, beta, act, ln)
    y_p = fd.dense_fwd_plain(x, w, b, gamma, beta, act, ln)
    dz, vecs = fd.dense_bwd(x, w, b, gamma, dy, act, ln)
    dz_p, vecs_p = fd.dense_bwd_plain(x, w, b, gamma, dy, act, ln)
    torch.cuda.synchronize()
    assert fd.dense_fwd.launches == f0 + 1 and fd.dense_bwd.launches == b0 + 1
    assert y.dtype == torch.bfloat16 and dz.dtype == torch.bfloat16
    assert float((y.float() - y_p.float()).abs().max()) <= _bf16_tol(y_p)
    assert _rel_l2(dz, dz_p) <= 2e-2
    assert vecs.shape == vecs_p.shape == ((3 if ln else 1), N)
    assert _rel_l2(vecs, vecs_p) <= 1e-3


@pytest.mark.parametrize("act,ln", [("gelu", False), ("none", True),
                                    ("gelu", True), ("none", False)])
def test_dense_kernels_take_fp32(dev, act, ln):
    """fp32 x launches K6/K6b (x and W as two bf16 terms, no TF32): y and
    dz within 1e-4 of their largest values, the column sums within relative
    L2 1e-3 (fp32 sums in another order); through autograd, dx and dW
    (fp32 products outside the kernel, TF32 off) within relative L2 1e-4 of
    fp32 products of the plain dz."""
    from mvuld_tpu_torch.ops import fused_dense as fd
    g = torch.Generator(device=dev).manual_seed(44)
    r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev, generator=g)  # noqa: E731
    M, K, N = 200, 256, 512
    x, w, b = r(M, K), r(K, N, sc=K ** -0.5), r(N, sc=0.1)
    gamma, beta, dy = 1 + r(N, sc=0.1), r(N, sc=0.1), r(M, N)
    f0, b0 = fd.dense_fwd.launches, fd.dense_bwd.launches
    y = fd.dense_fwd(x, w, b, gamma, beta, act, ln)
    dz, vecs = fd.dense_bwd(x, w, b, gamma, dy, act, ln)
    y_p = fd.dense_fwd_plain(x, w, b, gamma, beta, act, ln)
    dz_p, vecs_p = fd.dense_bwd_plain(x, w, b, gamma, dy, act, ln)
    torch.cuda.synchronize()
    assert fd.dense_fwd.launches == f0 + 1 and fd.dense_bwd.launches == b0 + 1
    assert y.dtype == torch.float32 and dz.dtype == torch.float32
    for a, want in ((y, y_p), (dz, dz_p)):
        assert float((a - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert _rel_l2(vecs, vecs_p) <= 1e-3
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = (fd.dense_ln(xg, wg, b, gamma, beta, act) if ln
           else fd.dense_act(xg, wg, b, act))
    gx, gw = torch.autograd.grad(out, (xg, wg), dy)
    assert _rel_l2(gx, dz_p @ w.t()) <= 1e-4
    assert _rel_l2(gw, x.t() @ dz_p) <= 1e-4


# (M, K, N): tile edges of the GEMM core (rows past 128, K past a 64-deep
# k-step, N past a 128-column tile), blockbench's fc1 and fc2, and a
# LayerNorm over 3072 columns
DENSE_EDGES = [(37, 64, 256), (200, 256, 64), (130, 80, 144)]
DENSE_CASES = ([(M, K, N, act, ln) for M, K, N in DENSE_EDGES
                for act, ln in (("gelu", False), ("none", True),
                                ("gelu", True), ("none", False))]
               + [(64 * 784, 512, 2048, "gelu", False),
                  (64 * 784, 2048, 512, "none", True),
                  (300, 512, 3072, "gelu", True)])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,act,ln", DENSE_CASES)
def test_dense_passes_match_plain(dev, M, K, N, act, ln, dtype):
    """K6 and K6b on the GEMM core against their plain versions: y and dz
    within two bf16 ulps of their largest values (fp32 x: 1e-4 of them),
    the column sums within relative L2 1e-3 (fp32 sums in another
    order)."""
    from mvuld_tpu_torch.ops import fused_dense as fd
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev, generator=g)  # noqa: E731
    x, w, b = r(M, K).to(dtype), r(K, N, sc=K ** -0.5), r(N, sc=0.1)
    gamma, beta, dy = 1 + r(N, sc=0.1), r(N, sc=0.1), r(M, N).to(dtype)
    f0, b0 = fd.dense_fwd.launches, fd.dense_bwd.launches
    y = fd.dense_fwd(x, w, b, gamma, beta, act, ln)
    dz, vecs = fd.dense_bwd(x, w, b, gamma, dy, act, ln)
    y_p = fd.dense_fwd_plain(x, w, b, gamma, beta, act, ln)
    dz_p, vecs_p = fd.dense_bwd_plain(x, w, b, gamma, dy, act, ln)
    torch.cuda.synchronize()
    assert fd.dense_fwd.launches == f0 + 1 and fd.dense_bwd.launches == b0 + 1
    assert y.dtype == dz.dtype == dtype and y.shape == dz.shape == (M, N)
    for a, want in ((y, y_p), (dz, dz_p)):
        tol = (1e-4 * float(want.abs().max()) if dtype == torch.float32
               else _bf16_tol(want))
        assert float((a.float() - want.float()).abs().max()) <= tol
    assert vecs.shape == vecs_p.shape == ((3 if ln else 1), N)
    assert _rel_l2(vecs, vecs_p) <= 1e-3


@pytest.mark.parametrize("act,ln", [("gelu", False), ("none", True),
                                    ("none", False)])
def test_dense_bwd_repeats_to_the_bit(dev, act, ln):
    """K6b's column sums go through per-tile or per-row-group partials
    added in a fixed order, with no atomics: two launches give the same
    bits, at a row count that makes many partials."""
    from mvuld_tpu_torch.ops import fused_dense as fd
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(5003, 256, device=dev, generator=g).bfloat16()
    w = torch.randn(256, 512, device=dev, generator=g) / 16
    b, gamma = torch.zeros(512, device=dev), torch.ones(512, device=dev)
    dy = torch.randn(5003, 512, device=dev, generator=g).bfloat16()
    first = fd.dense_bwd(x, w, b, gamma, dy, act, ln)
    second = fd.dense_bwd(x, w, b, gamma, dy, act, ln)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_dense_ln_autograd_runs_the_kernels(dev):
    from mvuld_tpu_torch.ops import fused_dense as fd
    x = torch.randn(130, 80, device=dev).bfloat16().requires_grad_()
    w = (0.1 * torch.randn(80, 144, device=dev)).requires_grad_()
    b = torch.zeros(144, device=dev, requires_grad=True)
    gamma = torch.ones(144, device=dev, requires_grad=True)
    beta = torch.zeros(144, device=dev, requires_grad=True)
    f0, b0 = fd.dense_fwd.launches, fd.dense_bwd.launches
    y = fd.dense_ln(x, w, b, gamma, beta, "gelu")
    grads = torch.autograd.grad(y.float().sum(), (x, w, b, gamma, beta))
    assert fd.dense_fwd.launches == f0 + 1 and fd.dense_bwd.launches == b0 + 1
    assert grads[0].dtype == torch.bfloat16 and grads[0].shape == x.shape
    assert all(torch.isfinite(t.float()).all() for t in grads)


def test_dense_autograd_runs_the_kernels(dev):
    from mvuld_tpu_torch.ops import fused_dense as fd
    x = torch.randn(50, 64, device=dev).bfloat16().requires_grad_()
    w = (0.1 * torch.randn(64, 128, device=dev)).requires_grad_()
    b = torch.zeros(128, device=dev, requires_grad=True)
    f0, b0 = fd.dense_fwd.launches, fd.dense_bwd.launches
    y = fd.dense_act(x, w, b, "gelu")
    gx, gw, gb = torch.autograd.grad(y.float().sum(), (x, w, b))
    assert fd.dense_fwd.launches == f0 + 1 and fd.dense_bwd.launches == b0 + 1
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    assert torch.isfinite(gw).all() and torch.isfinite(gb).all()


def test_matmul_f32_and_its_gradient_on_the_card(dev):
    """The fp32-output product of bf16 operands (blockbench v2, the dense
    backward) against fp32 products of the same values: 1e-5 relative L2
    (fp32 sums in another order); its gradients within 1e-2 (the cotangent
    is rounded to bf16 before its products)."""
    from mvuld_tpu_torch.ops.fused_dense import matmul_f32
    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.randn(64, 96, device=dev, generator=g).bfloat16().requires_grad_()
    b = torch.randn(96, 32, device=dev, generator=g).bfloat16().requires_grad_()
    y = matmul_f32(a, b)
    assert y.dtype == torch.float32
    assert _rel_l2(y, a.float() @ b.float()) <= 1e-5
    ga, gb = torch.autograd.grad(y.sum(), (a, b))
    ones = torch.ones(64, 32, device=dev)
    assert ga.dtype == torch.bfloat16 and gb.dtype == torch.bfloat16
    assert _rel_l2(ga, ones @ b.float().t()) <= 1e-2
    assert _rel_l2(gb, a.float().t() @ ones) <= 1e-2


def _attn_inputs(dev, seed, H, N, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    bias = 16 * torch.sigmoid(torch.randn(H, N, N, device=dev, generator=g))
    ls = 10.0 + torch.rand(H, device=dev, generator=g)
    return g, bias, ls


def _grad_tols(want, dtype):
    """dq/dk/dv (or dqkv) fp32 1e-4 of the largest, bf16 two ulps; dbias
    1e-4 and dscale 1e-3 of their largest (sums over every window)."""
    big = lambda t: float(t.float().abs().max())  # noqa: E731
    first = [1e-4 * big(t) if dtype == torch.float32 else _bf16_tol(t)
             for t in want[:-2]]
    return first + [1e-4 * big(want[-2]), 1e-3 * big(want[-1])]


# (Bn, ws, nW of the mask or 0): N not a multiple of 16, fewer mask windows
# than windows, a window count that is no multiple of an image grid
HEAD_GEOMS = [(6, 4, 0), (8, 8, 4), (9, 7, 3), (4, 9, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", HEAD_GEOMS,
                         ids=["ws4", "ws8_mask4", "ws7_mask3", "ws9_mask2"])
def test_head_layout_kernels_match_plain(dev, geom, dtype):
    """K8 and K8b against their plain versions, mask operand included (a
    0 / −100 shift mask for a 2×2 grid where nW is 4, random otherwise)."""
    from mvuld_tpu_torch.ops import window_attention as wa
    Bn, ws, nW = geom
    H, hd, N = 2, 32, ws * ws
    g, bias, ls = _attn_inputs(dev, 10, H, N, dtype)
    q, k, v, gout = (torch.randn(Bn, H, N, hd, device=dev, generator=g
                                 ).to(dtype) for _ in range(4))
    mask = None
    if nW == 4:
        mask = torch.as_tensor(wa.window_region_mask(ws, ws // 2, 2, 2),
                               device=dev)
    elif nW:
        mask = -100.0 * (torch.rand(nW, N, N, device=dev, generator=g) < 0.3)
    n0 = (wa.window_attention_fwd.launches, wa.window_attention_bwd.launches)
    got = wa.window_attention_fwd(q, k, v, bias, ls, mask)
    want = wa.window_attention_plain(q, k, v, bias, ls, mask)
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else _bf16_tol(want)
    assert float((got.float() - want.float()).abs().max()) <= tol
    grads = wa.window_attention_bwd(q, k, v, bias, ls, gout, mask)
    wants = wa.window_attention_bwd_plain(q, k, v, bias, ls, gout, mask)
    assert (wa.window_attention_fwd.launches,
            wa.window_attention_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    for a, b, t in zip(grads, wants, _grad_tols(wants, dtype)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= t


# (B, window rows, window columns, ws, shift)
MAP_GEOMS = [(2, 1, 1, 4, 0), (2, 2, 2, 8, 4), (1, 3, 2, 7, 3)]


@pytest.mark.parametrize("mxu_bf16", [False, True], ids=["fp32", "mxu_bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", MAP_GEOMS,
                         ids=["ws4", "ws8_shift4", "ws7_ragged_shift3"])
def test_map_layout_kernels_match_plain(dev, geom, dtype, mxu_bf16):
    """K7 and K7b read the map in place: fp32 outputs whatever the input
    dtype, within 1e-4 of the largest value of their plain versions (with
    ``mxu_bf16`` both round the same operands to bf16 and a value on a
    rounding boundary may go either way, so two bf16 ulps there)."""
    from mvuld_tpu_torch.ops import window_attention as wa
    B, nWh, nWw, ws, shift = geom
    H, hd, N = 3, 32, ws * ws
    g, bias, ls = _attn_inputs(dev, 11, H, N, dtype)
    qkv = torch.randn(B, nWh * ws, nWw * ws, 3, H, hd, device=dev,
                      generator=g).to(dtype)
    gout = torch.randn(B, nWh * ws, nWw * ws, H, hd, device=dev, generator=g)
    rel = 2.0 ** -6 if mxu_bf16 else 1e-4
    big = lambda t: float(t.abs().max())  # noqa: E731
    got = wa.window_attention_map_fwd(qkv, bias, ls, shift, mxu_bf16)
    want = wa.window_attention_map_plain(qkv, bias, ls, shift, mxu_bf16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= rel * big(want)
    grads = wa.window_attention_map_bwd(qkv, bias, ls, gout, shift, mxu_bf16)
    wants = wa.window_attention_map_bwd_plain(qkv, bias, ls, gout, shift,
                                              mxu_bf16)
    assert grads[0].dtype == torch.float32
    for a, b, r in zip(grads, wants, (rel, rel, max(rel, 1e-3))):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= r * big(b)


# window sides whose N = ws² is 12.25 tiles of 16 (196) and 49 of them (784,
# the published window): (ws, Bn per image grid 2×2, H). At N 784 with
# SwinV2-B's 8 heads of stage 2 dbias is summed in one chunk
# (``_bwd_scratch``), with 2 heads in two.
LARGE_WINDOWS = [(14, 2), (28, 2), (28, 8)]


@pytest.mark.parametrize("layout", ["head_bf16", "head_fp32", "map_bf16",
                                    "map_bf16_mxu", "map_fp32"])
@pytest.mark.parametrize("ws,H", LARGE_WINDOWS,
                         ids=["ws14", "ws28", "ws28_h8"])
def test_backward_kernels_at_the_model_windows(dev, ws, H, layout):
    """K8b (mask operand, bf16 in / bf16 out and fp32 / fp32) and K7b
    (synthesised mask, bf16 or fp32 in / fp32 out, bf16 also with
    ``mxu_bf16``) at N = 196 and 784 on a shifted 2×2 grid of windows."""
    from mvuld_tpu_torch.ops import window_attention as wa
    N, hd, shift = ws * ws, 32, ws // 2
    dtype = torch.float32 if layout.endswith("fp32") else torch.bfloat16
    g, bias, ls = _attn_inputs(dev, 20, H, N, dtype)
    qkv = torch.randn(1, 2 * ws, 2 * ws, 3, H, hd, device=dev, generator=g
                      ).to(dtype)
    gout = torch.randn(1, 2 * ws, 2 * ws, H, hd, device=dev, generator=g)
    if layout.startswith("map"):
        mxu = layout.endswith("mxu")
        got = wa.window_attention_map_bwd(qkv, bias, ls, gout, shift, mxu)
        want = wa.window_attention_map_bwd_plain(qkv, bias, ls, gout, shift,
                                                 mxu)
        # with mxu_bf16 dbias and dscale as K2's and K5's (1e-3, 1e-2)
        rels = (2.0 ** -6, 1e-3, 1e-2) if mxu else (1e-4, 1e-4, 1e-3)
        tols = [r * float(w.abs().max()) for r, w in zip(rels, want)]
    else:
        q, k, v = (t.to(dtype).contiguous()
                   for t in wa._map_to_windows(qkv, ws))
        gh = wa._heads_map_to_windows(gout, ws).to(dtype)
        mask = wa.window_region_mask(ws, shift, 2, 2)
        got = wa.window_attention_bwd(q, k, v, bias, ls, gh, mask)
        want = wa.window_attention_bwd_plain(q, k, v, bias, ls, gh, mask)
        tols = _grad_tols(want, dtype)
    torch.cuda.synchronize()
    for a, b, t in zip(got, want, tols):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= t


@pytest.mark.parametrize("ws,shift", [(4, 0), (8, 4), (7, 3), (14, 7)],
                         ids=["ws4", "ws8_shift4", "ws7_shift3", "ws14_shift7"])
def test_backward_layouts_agree_to_the_bit_and_repeat(dev, ws, shift):
    """The head layout (mask operand, bf16 outputs) and the map layout
    (synthesised mask, fp32 outputs) run the same arithmetic in the same
    order on the same numbers: dqkv rounded to bf16, dbias and dscale are
    identical to the bit, and a second run repeats the first (no atomics)."""
    from mvuld_tpu_torch.ops import window_attention as wa
    B, nW1, H, hd, N = 3, 2, 2, 32, ws * ws
    g, bias, ls = _attn_inputs(dev, 21, H, N, torch.bfloat16)
    qkv = torch.randn(B, nW1 * ws, nW1 * ws, 3, H, hd, device=dev,
                      generator=g).to(torch.bfloat16)
    gout = torch.randn(B, nW1 * ws, nW1 * ws, H, hd, device=dev, generator=g
                       ).to(torch.bfloat16).float()
    q, k, v = (t.to(torch.bfloat16).contiguous()
               for t in wa._map_to_windows(qkv, ws))
    gh = wa._heads_map_to_windows(gout, ws).to(torch.bfloat16)
    mask = wa.window_region_mask(ws, shift, nW1, nW1) if shift else None
    first = wa.window_attention_map_bwd(qkv, bias, ls, gout, shift)
    again = wa.window_attention_map_bwd(qkv, bias, ls, gout, shift)
    head = wa.window_attention_bwd(q, k, v, bias, ls, gh, mask)
    head_again = wa.window_attention_bwd(q, k, v, bias, ls, gh, mask)
    torch.cuda.synchronize()
    for a, b in zip(first + head, again + head_again):
        assert torch.equal(a, b)
    dqkv_h = wa._windows_to_map(torch.stack(head[:3]), B, nW1 * ws, nW1 * ws,
                                ws)
    assert torch.equal(dqkv_h, first[0].to(torch.bfloat16))
    assert torch.equal(head[3], first[1]) and torch.equal(head[4], first[2])


def test_backward_takes_views_that_start_off_a_16_byte_boundary(dev):
    """The kernels load 16 bytes a thread; a view whose first row starts
    elsewhere is copied by the wrapper, not refused."""
    from mvuld_tpu_torch.ops import window_attention as wa
    H, N, hd = 2, 16, 32
    g, bias, ls = _attn_inputs(dev, 22, H, N, torch.bfloat16)
    flat = torch.randn(4 * 4 * H * N * hd + 1, device=dev, generator=g
                       ).to(torch.bfloat16)
    q, k, v, gout = flat[1:].reshape(4, 4, H, N, hd).unbind(0)
    assert q.data_ptr() % 16 != 0
    got = wa.window_attention_bwd(q, k, v, bias, ls, gout)
    want = wa.window_attention_bwd_plain(q, k, v, bias, ls, gout)
    for a, b, t in zip(got, want, _grad_tols(want, torch.bfloat16)):
        assert float((a.float() - b.float()).abs().max()) <= t


def test_window_attention_entry_points_backward_on_card(dev):
    """Autograd through both entry points launches K8b / K7b, casts dqkv
    back to qkv's dtype, and the two layouts agree on the same numbers."""
    from mvuld_tpu_torch.ops import window_attention as wa
    B, nW1, ws, shift, H, hd = 2, 2, 8, 4, 2, 32
    N = ws * ws
    g, bias, ls = _attn_inputs(dev, 12, H, N, torch.bfloat16)
    qkv = torch.randn(B, nW1 * ws, nW1 * ws, 3, H, hd, device=dev,
                      generator=g).to(torch.bfloat16).requires_grad_()
    bias.requires_grad_()
    ls.requires_grad_()
    n0 = (wa.window_attention_map_bwd.launches, wa.window_attention_bwd.launches)
    out = wa.window_attention_map(qkv, bias, ls, shift)
    w = torch.randn(out.shape, device=dev, generator=g)
    gm = torch.autograd.grad((out * w).sum(), (qkv, bias, ls))
    assert out.dtype == torch.float32 and gm[0].dtype == torch.bfloat16
    q, k, v = (t.to(torch.bfloat16).requires_grad_()
               for t in wa._map_to_windows(qkv.detach(), ws))
    mask = wa.window_region_mask(ws, shift, nW1, nW1)
    out_h = wa.window_attention(q, k, v, bias, ls, mask)
    wh = wa._heads_map_to_windows(w, ws)
    gh = torch.autograd.grad((out_h.float() * wh).sum(), (q, k, v, bias, ls))
    assert (wa.window_attention_map_bwd.launches,
            wa.window_attention_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    out_hm = wa._windows_to_map(out_h.float(), B, nW1 * ws, nW1 * ws, ws)
    assert float((out_hm - out).detach().abs().max()) <= _bf16_tol(out.detach())
    dqkv_h = wa._windows_to_map(torch.stack([t.float() for t in gh[:3]]),
                                B, nW1 * ws, nW1 * ws, ws)
    assert _rel_l2(dqkv_h, gm[0]) <= 2e-2       # two bf16 roundings apart
    assert _rel_l2(gh[3], gm[1]) <= 2e-2 and _rel_l2(gh[4], gm[2]) <= 2e-2


def test_new_attention_kernels_reject_other_head_dims(dev):
    from mvuld_tpu_torch.ops import window_attention as wa
    q = torch.zeros(2, 2, 16, 8, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        wa.window_attention_fwd(q, q, q, torch.zeros(2, 16, 16, device=dev),
                                torch.ones(2, device=dev))
    with pytest.raises(ValueError, match="head dim"):
        wa.window_attention_map_fwd(torch.zeros(1, 4, 4, 3, 2, 8, device=dev),
                                    torch.zeros(2, 16, 16, device=dev),
                                    torch.ones(2, device=dev))


# K2 and K5 on the tensor-core passes of csrc/window_attention.cu, at the
# model's windows: N = 196 (ws 14) and 784 (ws 28), unshifted and shifted
# on a 2×2 grid of windows, bf16 and fp32; at N 784 also with the batch-16
# step's stage-2 windows and heads (Bn 64, H 8: dbias summed over all 64
# windows in one chunk, where 8 windows of 2 heads take three). Tolerances
# as every backward's:
# fp32 dq, dk, dv within 1e-4 of their largest value, bf16 ones within two
# bf16 ulps, dbias 1e-4 and dscale 1e-3 of their largest.

def _flat_inputs(dev, seed, Bn, ws, H, dtype, scale=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    N, C = ws * ws, H * 32
    qkv = torch.randn(Bn, N, 3 * C, device=dev, generator=g).to(dtype)
    bias = 16 * torch.sigmoid(torch.randn(H, N, N, device=dev, generator=g))
    ls = (torch.full((H,), float(scale), device=dev) if scale else
          math.log(10.0) + 0.1 * torch.randn(H, device=dev, generator=g))
    gout = torch.randn(Bn, N, C, device=dev, generator=g).to(dtype)
    return qkv, bias, ls, gout


def _flat_grads(kind, qkv, bias, ls, gout, geom, mxu_bf16=False, plain=False):
    from mvuld_tpu_torch.ops import window_attention as wa
    if kind == "k5":
        fn = (wa.window_attention_flat_bwd_v1_plain if plain
              else wa.window_attention_flat_bwd_v1)
        return fn(qkv, bias, ls, gout, *geom, mxu_bf16=mxu_bf16)
    out, r = wa.window_attention_flat_plain(qkv, bias, ls, *geom,
                                            return_rowsum=True,
                                            mxu_bf16=mxu_bf16)
    fn = (wa.window_attention_flat_bwd_plain if plain
          else wa.window_attention_flat_bwd)
    return fn(qkv, bias, ls, out, r, gout, *geom, mxu_bf16=mxu_bf16)


def _split_dqkv(grads):
    dqkv, dbias, dscale = grads
    C = dqkv.shape[-1] // 3
    return [dqkv[..., i * C:(i + 1) * C] for i in range(3)] + [dbias, dscale]


@pytest.mark.parametrize("kind", ["k2", "k5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True], ids=["shift0", "shifted"])
@pytest.mark.parametrize("ws,Bn,H", [(14, 8, 2), (28, 8, 2), (28, 64, 8)],
                         ids=["14", "28", "28_bn64_h8"])
def test_flat_backward_kernels_at_the_model_windows(dev, ws, Bn, H, shifted,
                                                    dtype, kind):
    from mvuld_tpu_torch.ops import window_attention as wa
    geom = (ws // 2, 2, 2) if shifted else (0, 1, 1)
    qkv, bias, ls, gout = _flat_inputs(dev, 30, Bn, ws, H, dtype)
    counter = (wa.window_attention_flat_bwd_v1 if kind == "k5"
               else wa.window_attention_flat_bwd)
    before = counter.launches
    fused = wa.window_attention_flat_bwd.fused_launches
    got = _flat_grads(kind, qkv, bias, ls, gout, geom)
    want = _flat_grads(kind, qkv, bias, ls, gout, geom, plain=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    # K2 runs its fused pass at every SwinV2 window; K5 never does
    assert wa.window_attention_flat_bwd.fused_launches \
        == fused + (kind == "k2")
    assert got[0].dtype == dtype and got[0].shape == qkv.shape
    got, want = _split_dqkv(got), _split_dqkv(want)
    for a, b, t in zip(got, want, _grad_tols(want, dtype)):
        assert torch.isfinite(a).all()
        assert float((a.float() - b.float()).abs().max()) <= t
    if kind == "k5":     # the same function as K2 (see the v1 test above)
        k2 = _split_dqkv(_flat_grads("k2", qkv, bias, ls, gout, geom))
        lim = 1e-4 if dtype == torch.float32 else 2e-2
        assert max(_rel_l2(a, b) for a, b in zip(got, k2)) <= lim


@pytest.mark.parametrize("kind,ws", [("k2", 14), ("k5", 14), ("k2", 28)],
                         ids=["k2", "k5", "k2_ws28"])
def test_flat_backward_repeats_to_the_bit(dev, kind, ws):
    """No atomics: two runs give the same bits (the windows summed into
    dbias in chunks, then in a fixed order; K2's dq shares added over a
    cluster of blocks in block order, seven blocks at ws 28)."""
    qkv, bias, ls, gout = _flat_inputs(dev, 31, 16, ws, 2, torch.bfloat16)
    geom = (ws // 2, 2, 2)
    first = _flat_grads(kind, qkv, bias, ls, gout, geom)
    again = _flat_grads(kind, qkv, bias, ls, gout, geom)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


# K2's fused key-outer pass (the blocks of a window side as one cluster)
# at the model's windows and head counts: N = 784 with SwinV2-B's heads of
# stages 1-3 (a cluster of seven blocks), N = 196 (two), N = 64 (one),
# unshifted and shifted, bf16 and fp32, with split operands at the
# backward's tolerances and with ``mxu_bf16`` at those of the mxu_bf16
# test below.
FUSED_GEOMS = [(28, 4), (28, 8), (28, 16), (14, 2), (8, 2)]


@pytest.mark.parametrize("mxu_bf16", [False, True], ids=["split", "mxu_bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True], ids=["shift0", "shifted"])
@pytest.mark.parametrize("ws,H", FUSED_GEOMS,
                         ids=["ws28_h4", "ws28_h8", "ws28_h16", "ws14_h2",
                              "ws8_h2"])
def test_flat_backward_fused_pass_at_the_model_windows(dev, ws, H, shifted,
                                                       dtype, mxu_bf16):
    from mvuld_tpu_torch.ops import window_attention as wa
    geom = (ws // 2, 2, 2) if shifted else (0, 1, 1)
    qkv, bias, ls, gout = _flat_inputs(dev, 36, 8, ws, H, dtype)
    fn = wa.window_attention_flat_bwd
    assert wa._k2_fused(ws * ws)
    before = (fn.launches, fn.fused_launches)
    got = _flat_grads("k2", qkv, bias, ls, gout, geom, mxu_bf16)
    torch.cuda.synchronize()
    assert (fn.launches, fn.fused_launches) == (before[0] + 1, before[1] + 1)
    want = _split_dqkv(_flat_grads("k2", qkv, bias, ls, gout, geom, mxu_bf16,
                                   plain=True))
    got = _split_dqkv(got)
    big = lambda t: float(t.float().abs().max())  # noqa: E731
    tols = ([r * big(w) for r, w in zip([2.0 ** -6] * 3 + [1e-3, 1e-2], want)]
            if mxu_bf16 else _grad_tols(want, dtype))
    for a, b, t in zip(got, want, tols):
        assert torch.isfinite(a).all()
        assert float((a.float() - b.float()).abs().max()) <= t


@pytest.mark.parametrize("kind", ["k2", "k5"])
def test_flat_backward_takes_views_off_a_16_byte_boundary(dev, kind):
    """The kernels load 16 bytes a thread; qkv, o and g views that start
    elsewhere are copied by the wrapper, not refused."""
    Bn, N, C = 4, 64, 64
    g = torch.Generator(device=dev).manual_seed(32)
    flat = torch.randn(Bn * N * 5 * C + 1, device=dev, generator=g
                       ).to(torch.bfloat16)
    qkv = flat[1:1 + Bn * N * 3 * C].reshape(Bn, N, 3 * C)
    gout = flat[1 + Bn * N * 3 * C:1 + Bn * N * 4 * C].reshape(Bn, N, C)
    assert qkv.data_ptr() % 16 != 0 and gout.data_ptr() % 16 != 0
    bias = 16 * torch.sigmoid(torch.randn(2, N, N, device=dev, generator=g))
    ls = torch.full((2,), math.log(10.0), device=dev)
    got = _split_dqkv(_flat_grads(kind, qkv, bias, ls, gout, (4, 2, 2)))
    want = _split_dqkv(_flat_grads(kind, qkv, bias, ls, gout, (4, 2, 2),
                                   plain=True))
    for a, b, t in zip(got, want, _grad_tols(want, torch.bfloat16)):
        assert float((a.float() - b.float()).abs().max()) <= t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["k2", "k5"])
def test_flat_backward_underflowing_row(dev, kind, dtype):
    """Query row 3 of every window has each logit 90-110 below the fixed
    shift m_h (scale 10, bias in [0, 1) but −90 on that row): exp(s − m) is
    subnormal or zero there (the kernels' ex2.approx flushes subnormals to
    zero), the row sum falls under the 1e-30 clamp and r = 1e30. The
    gradients stay finite and within the usual tolerances."""
    from mvuld_tpu_torch.ops import window_attention as wa
    qkv, _, _, gout = _flat_inputs(dev, 33, 8, 8, 2, dtype)
    g = torch.Generator(device=dev).manual_seed(34)
    bias = torch.rand(2, 64, 64, device=dev, generator=g)
    bias[:, 3, :] = -90.0
    ls = torch.full((2,), 10.0, device=dev)
    _, r = wa.window_attention_flat_plain(qkv, bias, ls, 4, 2, 2,
                                          return_rowsum=True)
    assert bool((r[:, :, 3] == 1e30).all())
    got = _split_dqkv(_flat_grads(kind, qkv, bias, ls, gout, (4, 2, 2)))
    want = _split_dqkv(_flat_grads(kind, qkv, bias, ls, gout, (4, 2, 2),
                                   plain=True))
    for a, b, t in zip(got, want, _grad_tols(want, dtype)):
        assert torch.isfinite(a).all()
        assert float((a.float() - b.float()).abs().max()) <= t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["k1", "k2", "k5"])
def test_flat_kernels_mxu_bf16_match_rounded_plain(dev, kind, dtype):
    """``mxu_bf16``: K1, K2 and K5 round their product operands to bf16 and
    the plain versions round the same values (K5's plain version rounds e
    and r·g where the kernel rounds p and g); a value on a rounding
    boundary may go either way, so outputs and dq, dk, dv within two bf16
    ulps of their largest value, dbias 1e-3 and dscale 1e-2 of theirs (the
    ``mxu_bf16`` tolerances of K7b)."""
    from mvuld_tpu_torch.ops import window_attention as wa
    qkv, bias, ls, gout = _flat_inputs(dev, 35, 8, 14, 2, dtype)
    geom = (7, 2, 2)
    big = lambda t: float(t.float().abs().max())  # noqa: E731
    if kind == "k1":
        got = wa.window_attention_flat(qkv, bias, ls, *geom, mxu_bf16=True)
        want = wa.window_attention_flat_plain(qkv, bias, ls, *geom,
                                              mxu_bf16=True)
        assert float((got.float() - want.float()).abs().max()) \
            <= 2.0 ** -6 * big(want)
        exact = wa.window_attention_flat(qkv, bias, ls, *geom)
        assert not torch.equal(exact, got)
        return
    got = _split_dqkv(_flat_grads(kind, qkv, bias, ls, gout, geom, True))
    want = _split_dqkv(_flat_grads(kind, qkv, bias, ls, gout, geom, True,
                                   plain=True))
    for a, b, rel in zip(got, want, [2.0 ** -6] * 3 + [1e-3, 1e-2]):
        assert float((a.float() - b.float()).abs().max()) <= rel * big(b)


# K1, K7 and K8 on the tensor-core forward passes of csrc/window_attention.cu,
# at the model's windows: N = 49, 196 and 784 (ws 7, 14, 28: the last strip
# of 16 rows ragged but at 784), unshifted and shifted on a 2×2 grid of
# windows, bf16 and fp32, all three layouts on the same seeded numbers.
# Tolerances as every forward's: fp32 outputs (K7's always) within 1e-4 of
# their largest value, bf16 ones within two bf16 ulps, K1's row sums within
# relative 1e-4; with ``mxu_bf16`` (kernel and plain version round the same
# operands, a value on a rounding boundary may go either way, and the logit
# it feeds moves by up to the scale times a bf16 ulp) outputs within two
# bf16 ulps of their largest value and K1's row sums within relative 2⁻⁶.

FORWARD_COUNTERS = {"k1": "window_attention_flat",
                    "k7": "window_attention_map_fwd",
                    "k8": "window_attention_fwd"}


def _map_qkv(dev, seed, ws, dtype, B=2, H=2):
    g, bias, ls = _attn_inputs(dev, seed, H, ws * ws, dtype)
    qkv = torch.randn(B, 2 * ws, 2 * ws, 3, H, 32, device=dev, generator=g
                      ).to(dtype)
    return qkv, bias, ls


def _off16(t):
    """A copy of t whose first element sits 2 or 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


def _forward(kind, qkv, bias, ls, shift, mxu_bf16=False, plain=False,
             view=lambda t: t):
    """K1 (on the map re-laid as flat windows; returns [out, r]), K7 (the
    map read in place) or K8 (q, k, v of the windows, the shift mask as an
    operand); ``view`` is applied to the kernel's inputs."""
    from mvuld_tpu_torch.ops import window_attention as wa
    B, Hp, _, _, H, hd = qkv.shape
    ws = math.isqrt(bias.shape[-1])
    nW1, N, C = Hp // ws, ws * ws, H * hd
    if kind == "k7":
        fn = (wa.window_attention_map_plain if plain
              else wa.window_attention_map_fwd)
        return [fn(view(qkv), bias, ls, shift, mxu_bf16)]
    if kind == "k8":
        q, k, v = (view(t.to(qkv.dtype).contiguous())
                   for t in wa._map_to_windows(qkv, ws))
        mask = wa.window_region_mask(ws, shift, nW1, nW1) if shift else None
        fn = wa.window_attention_plain if plain else wa.window_attention_fwd
        return [fn(q, k, v, bias, ls, mask)]
    flat = qkv.reshape(B, nW1, ws, nW1, ws, 3 * C).permute(
        0, 1, 3, 2, 4, 5).reshape(B * nW1 * nW1, N, 3 * C)
    fn = (wa.window_attention_flat_plain if plain
          else wa.window_attention_flat)
    return list(fn(view(flat), bias, ls, shift, nW1, nW1, return_rowsum=True,
                   mxu_bf16=mxu_bf16))


def _assert_forward_close(kind, got, want, mxu_bf16=False):
    out, ref = got[0], want[0]
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    rel = (2.0 ** -6 if mxu_bf16 or out.dtype == torch.bfloat16 else 1e-4)
    assert float((out.float() - ref.float()).abs().max()) \
        <= rel * float(ref.float().abs().max())
    if kind == "k1":      # with mxu_bf16 a flipped q̂ or k̂ rounding moves r
        assert float(((got[1] - want[1]) / want[1]).abs().max()) \
            <= (2.0 ** -6 if mxu_bf16 else 1e-4)


@pytest.mark.parametrize("kind", ["k1", "k7", "k8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True], ids=["shift0", "shifted"])
@pytest.mark.parametrize("ws", [7, 14, 28])
def test_forward_kernels_at_the_model_windows(dev, ws, shifted, dtype, kind):
    from mvuld_tpu_torch.ops import window_attention as wa
    qkv, bias, ls = _map_qkv(dev, 40, ws, dtype)
    shift = ws // 2 if shifted else 0
    counter = getattr(wa, FORWARD_COUNTERS[kind])
    before = counter.launches
    got = _forward(kind, qkv, bias, ls, shift)
    want = _forward(kind, qkv, bias, ls, shift, plain=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    _assert_forward_close(kind, got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["k1", "k7"])
def test_forward_kernels_mxu_bf16_match_rounded_plain(dev, kind, dtype):
    qkv, bias, ls = _map_qkv(dev, 41, 14, dtype)
    got = _forward(kind, qkv, bias, ls, 7, mxu_bf16=True)
    want = _forward(kind, qkv, bias, ls, 7, mxu_bf16=True, plain=True)
    _assert_forward_close(kind, got, want, mxu_bf16=True)
    assert not torch.equal(got[0], _forward(kind, qkv, bias, ls, 7)[0])


@pytest.mark.parametrize("kind", ["k1", "k7", "k8"])
def test_forward_kernels_repeat_to_the_bit(dev, kind):
    qkv, bias, ls = _map_qkv(dev, 42, 14, torch.bfloat16)
    first = _forward(kind, qkv, bias, ls, 7)
    again = _forward(kind, qkv, bias, ls, 7)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["k1", "k7", "k8"])
def test_forward_kernels_take_views_off_a_16_byte_boundary(dev, kind):
    """The kernels load 16 bytes a thread; a view that starts elsewhere is
    copied by the wrapper, not refused."""
    qkv, bias, ls = _map_qkv(dev, 43, 8, torch.bfloat16)
    got = _forward(kind, qkv, bias, ls, 4, view=_off16)
    want = _forward(kind, qkv, bias, ls, 4, plain=True)
    _assert_forward_close(kind, got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_forward_underflowing_row(dev, dtype):
    """Query row 3 of every window has each logit 90-110 below the fixed
    shift m_h (scale 10, bias in [0, 1) but −90 on that row): its exps flush
    to zero in the kernel (ex2.approx.ftz) and are subnormal in the plain
    version, the row sum falls under the 1e-30 clamp on both sides, r =
    1e30, and the output stays finite and within the usual tolerances."""
    from mvuld_tpu_torch.ops import window_attention as wa
    qkv, _, _, _ = _flat_inputs(dev, 44, 8, 8, 2, dtype)
    g = torch.Generator(device=dev).manual_seed(45)
    bias = torch.rand(2, 64, 64, device=dev, generator=g)
    bias[:, 3, :] = -90.0
    ls = torch.full((2,), 10.0, device=dev)
    got = list(wa.window_attention_flat(qkv, bias, ls, 4, 2, 2,
                                        return_rowsum=True))
    want = list(wa.window_attention_flat_plain(qkv, bias, ls, 4, 2, 2,
                                               return_rowsum=True))
    assert bool((got[1][:, :, 3] == 1e30).all())
    _assert_forward_close("k1", got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws,H", [(14, 2), (28, 4)], ids=["ws14", "ws28_h4"])
def test_flat_backward_from_the_forward_kernel(dev, ws, H, dtype):
    """K2 (its fused pass) from the new K1's output and row sums: within
    the backward's tolerances of the plain backward fed the same (o, r);
    against the plain backward fed the plain forward's (o, r) within those
    tolerances in fp32 and within relative L2 2e-2 in bf16, where a bf16 o
    may sit one rounding step from the plain forward's and t = rowsum(g·o)
    moves with it."""
    from mvuld_tpu_torch.ops import window_attention as wa
    qkv, bias, ls, gout = _flat_inputs(dev, 46, 8, ws, H, dtype)
    geom = (ws // 2, 2, 2)
    o, r = wa.window_attention_flat(qkv, bias, ls, *geom, return_rowsum=True)
    got = _split_dqkv(wa.window_attention_flat_bwd(qkv, bias, ls, o, r, gout,
                                                   *geom))
    same = _split_dqkv(wa.window_attention_flat_bwd_plain(
        qkv, bias, ls, o, r, gout, *geom))
    for a, b, t in zip(got, same, _grad_tols(same, dtype)):
        assert torch.isfinite(a).all()
        assert float((a.float() - b.float()).abs().max()) <= t
    want = _split_dqkv(_flat_grads("k2", qkv, bias, ls, gout, geom,
                                   plain=True))
    if dtype == torch.float32:
        for a, b, t in zip(got, want, _grad_tols(want, dtype)):
            assert float((a - b).abs().max()) <= t
    else:
        assert max(_rel_l2(a, b) for a, b in zip(got, want)) <= 2e-2


# ------------------------------------------ clip + AdamW (fused_adamw.cu)

ADAMW_SIZES = (1, 3, 4097, 65537, 2 ** 24 + 5)


def _adamw_lists(dev, seed, sizes=ADAMW_SIZES, offset=0):
    """p, g, m, v lists (v ≥ 0, a few exact zeros in g); ``offset`` > 0
    takes every tensor as a view that starts ``offset`` floats into its
    storage (off 16 bytes: the kernels' scalar path)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def one(n, scale=1.0, pos=False):
        t = scale * torch.randn(n + offset, device=dev, generator=g)
        return (t.abs() if pos else t)[offset:]

    ps = [one(n) for n in sizes]
    gs = [one(n, 3.0) for n in sizes]
    for t in gs:
        t[::7] = 0.0
    ms = [one(n, 0.1) for n in sizes]
    vs = [one(n, 0.01, pos=True) for n in sizes]
    return ps, gs, ms, vs


def _adamw_coefs(dev, clip, gated=False):
    """The device scalars ``Optimizer.update`` hands ``fused_adamw``: step
    3's bias corrections at lr 1e-3; ``gated``, a MultiSteps micro-step
    that does not emit (b1 = b2 = 1, omb1 = omb2 = lr = 0)."""
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    betas = f([0.9, 0.999])
    corr = 1 - torch.pow(betas, f(3.0))
    s = {"neg_lr": f(0.0 if gated else -1e-3), "c1": corr[0], "c2": corr[1],
         "b1": f(1.0 if gated else 0.9), "omb1": f(0.0 if gated else 0.1),
         "b2": f(1.0 if gated else 0.999),
         "omb2": f(0.0 if gated else 1 - 0.999)}
    if clip is not None:
        s["clip"] = f(clip)
    return s


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off16"])
@pytest.mark.parametrize("clip,gated", [(0.37, False), (1.0, False),
                                        (None, False), (0.37, True)],
                         ids=["clip_engaged", "clip_off", "no_clip",
                              "multisteps_gated"])
def test_fused_adamw_equals_the_foreach_chain_to_the_bit(dev, clip, gated,
                                                         offset):
    """For a given clip factor, one ``fused_adamw`` call leaves p, m and v
    equal to the bit to those of the ``_foreach`` chain (``adamw_plain``)
    over sizes 1, 3, 4097, 65537 and 2²⁴ + 5, decayed and undecayed
    alternately (wd 0.05), aligned and on views off 16 bytes; a gated
    micro-step leaves all three as they were."""
    from mvuld_tpu_torch.ops import fused_adamw as fa
    ps, gs, ms, vs = _adamw_lists(dev, 50, offset=offset)
    decay = [i % 2 == 1 for i in range(len(ps))]
    s = _adamw_coefs(dev, clip, gated)
    want = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    start = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    fa.adamw_plain(*want[:1], gs, *want[1:], decay, s, 1e-8, 0.05)
    before = fa.fused_adamw.launches
    fa.fused_adamw(ps, gs, ms, vs, decay, s, 1e-8, 0.05)
    torch.cuda.synchronize()
    assert fa.fused_adamw.launches == before + 1
    for got, exp, old in zip((ps, ms, vs), want, start):
        for a, b, c in zip(got, exp, old):
            assert torch.equal(a, b)
            assert torch.equal(a, c) == gated


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off16"])
def test_sumsq_matches_fp64_and_repeats_to_the_bit(dev, offset):
    """``sumsq`` over the mixed list is within 2e-6 relative of an fp64 sum
    of the squares, and a second call gives the same bits."""
    from mvuld_tpu_torch.ops import fused_adamw as fa
    _, gs, _, _ = _adamw_lists(dev, 51, offset=offset)
    want = sum(float((g.double() ** 2).sum()) for g in gs)
    before = fa.sumsq.launches
    a, b = fa.sumsq(gs), fa.sumsq(gs)
    assert fa.sumsq.launches == before + 2
    assert a.dtype == torch.float32 and a.shape == ()
    assert abs(float(a) - want) <= 2e-6 * want
    assert torch.equal(a, b)


def test_optimizer_on_the_card_runs_the_kernels_only(dev):
    """``Optimizer.update`` of AdamW on the card: every update through
    ``fused_adamw`` (the ``_foreach`` count stays 0), its returned norm the
    clip's (``sumsq``, 2e-6 of fp64); a replaced ``norm`` feeds the clip and
    ``sumsq`` then does not run; and a step equals the ``_foreach`` chain
    given the same clip factor."""
    from mvuld_tpu_torch.core.optim import Optimizer, _clip_scale
    from mvuld_tpu_torch.ops import fused_adamw as fa
    ps, gs, _, _ = _adamw_lists(dev, 52, sizes=(4097, 3, 65537))
    names = ["w", "norm_scale", "kernel"]
    opt = Optimizer(list(zip(names, ps)), {"w": True, "norm_scale": False,
                                           "kernel": True},
                    lambda count: 1e-3, weight_decay=0.05, clip=5.0)
    launches = fa.fused_adamw.launches
    for scale in (1.0, 1e-4):
        grads = [scale * g for g in gs]
        want = [p.clone() for p in ps], [m.clone() for m in opt.mu], \
            [v.clone() for v in opt.nu]
        norm = opt.update(grads)
        ref = sum(float((g.double() ** 2).sum()) for g in grads) ** 0.5
        assert abs(float(norm) - ref) <= 2e-6 * ref
        s = _adamw_coefs(dev, None)
        corr = 1 - torch.pow(opt.betas_t, opt.count_t.float())
        s.update(c1=corr[0], c2=corr[1], clip=_clip_scale(5.0, norm),
                 neg_lr=torch.full((), -1e-3, device=dev))
        fa.adamw_plain(want[0], grads, want[1], want[2],
                       [True, False, True], s, opt.eps, 0.05)
        for got, exp in zip((ps, opt.mu, opt.nu), want):
            assert all(torch.equal(a, b) for a, b in zip(got, exp))
    assert opt.foreach_updates == 0 and opt.fused_updates == 2
    assert fa.fused_adamw.launches == launches + 2
    sums = fa.sumsq.launches
    opt.norm = lambda grads: torch.full((), 50.0, device=dev)
    assert float(opt.update(gs)) == 50.0
    assert fa.sumsq.launches == sums and opt.foreach_updates == 0


OPTAX_STEPS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "optax_steps.json")


@pytest.mark.parametrize("case", ["adamw_clip", "sgd_nesterov_clip",
                                  "adamw_multisteps2"])
def test_optimizer_on_the_card_matches_optax(dev, case):
    """``Optimizer.update`` on the card (AdamW: ``sumsq``, the clip and
    MultiSteps' gates through ``fused_adamw``) over the inputs of
    ``tests/test_torch_train.py::test_optimizer_steps_match_optax``:
    parameters within 1e-6 of optax's after each step, as recorded in
    ``tests/fixtures/optax_steps.json`` (held to optax on the CPU by
    ``test_optax_steps_fixture_is_optax``)."""
    from mvuld_tpu_torch.core.optim import Optimizer
    from mvuld_tpu_torch.core.schedule import cosine_schedule
    with open(OPTAX_STEPS) as f:
        fx = json.load(f)
    c = fx["cases"][case]
    tensor = lambda vals, n: torch.tensor(  # noqa: E731
        vals, dtype=torch.float32, device=dev).reshape(fx["shapes"][n])
    tp = {n: tensor(v, n) for n, v in fx["params"].items()}
    opt = Optimizer(list(tp.items()), fx["mask"],
                    cosine_schedule(*fx["schedule"]), name=c["name"],
                    weight_decay=fx["weight_decay"], clip=fx["clip"],
                    accumulation_steps=c["k"])
    for grads, want in zip(fx["grads"], c["steps"]):
        opt.update([tensor(grads[n], n) for n in tp])
        for n in tp:
            np.testing.assert_allclose(
                tp[n].cpu().numpy().ravel(), np.float32(want[n]),
                atol=1e-6, rtol=1e-6, err_msg=n)
    if c["name"] == "adamw":
        assert opt.foreach_updates == 0
        assert opt.fused_updates == len(fx["grads"])


# ------------------------------------------ K steps per call (CUDA graph)

def _tiny_swin_training(dev, drop_rate):
    from types import SimpleNamespace

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.train.train_swin import build_swin_training
    opts = ["DATA.IMG_SIZE", 32, "MODEL.SWINV2.EMBED_DIM", 64,
            "MODEL.SWINV2.DEPTHS", [2, 2], "MODEL.SWINV2.NUM_HEADS", [2, 4],
            "MODEL.SWINV2.WINDOW_SIZE", 4,
            "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", [0, 0],
            "MODEL.DROP_PATH_RATE", 0.2, "MODEL.DROP_RATE", drop_rate,
            "MODEL.NUM_CLASSES", 2, "PARALLEL.DTYPE", "bfloat16",
            "TRAIN.FUSED_MLP", True, "TRAIN.USE_CHECKPOINT", True,
            "TRAIN.REMAT_STAGES", [0], "DATA.BATCH_SIZE", 4, "SEED", 0]
    cfg = get_config(SimpleNamespace(cfg=None, opts=opts, output="unused"))
    return build_swin_training(cfg, dev, steps_per_epoch=8)


@pytest.mark.parametrize("drop_rate", [0.0, 0.1], ids=["droppath",
                                                      "dropout_remat"])
def test_multi_step_graph_replay_equals_eager_steps(dev, drop_rate):
    """One replay of the captured K = 3 steps of a tiny SwinV2 from a saved
    state equals 3 eager steps from it (``_replay_equals_eager``: the
    DropPath and dropout masks to the bit, the losses within fp32 relative
    1e-6 and the parameter update within relative L2 1e-5; the same
    kernels in the same order, where a library backward that sums with
    atomics may move last bits). K1 and K2 run, and at rate 0 K3 and K3b
    (dropout takes the MLP off the fused kernel, as in JAX)."""
    from mvuld_tpu_torch.core.train_state import image_inputs
    from mvuld_tpu_torch.ops import fused_dense as fd
    from mvuld_tpu_torch.ops import window_attention as wa

    run = _tiny_swin_training(dev, drop_rate)
    k = 3
    rng = np.random.RandomState(0)
    sb = {"image": rng.randn(k, 4, 32, 32, 3).astype(np.float32),
          "label": rng.randint(0, 2, (k, 4)).astype(np.int32)}
    mlp = [fd.mlp_ln, fd.mlp_ln_bwd]
    before = [f.launches for f in mlp]
    _replay_equals_eager(
        run.model, run.opt, image_inputs, sb,
        torch.Generator(device=dev).manual_seed(1),
        kernels=[wa.window_attention_flat, wa.window_attention_flat_bwd]
        + (mlp if drop_rate == 0.0 else []),
        label_smoothing=run.label_smoothing)
    if drop_rate:
        assert [f.launches for f in mlp] == before


def test_multi_step_refuses_a_gloo_group_on_the_card(dev):
    """Gloo moves CUDA tensors through the host: a capture under a gloo
    group raises (nothing falls back to eager steps)."""
    import numpy as np
    import torch.distributed as dist

    from mvuld_tpu_torch.parallel.distributed import free_port
    from mvuld_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        run = _tiny_swin_training(dev, 0.0)
        run.mesh = make_mesh()
        rng = np.random.RandomState(0)
        sb = {"image": rng.randn(2, 4, 32, 32, 3).astype(np.float32),
              "label": rng.randint(0, 2, (2, 4)).astype(np.int32)}
        with pytest.raises(ValueError, match="NCCL"):
            run.multi_step(2)(sb, torch.Generator(device=dev))
        assert run.opt.count == 0
    finally:
        dist.destroy_process_group()


def _full_state(model, opt, gen):
    """What a replay reads: the parameters, the module buffers (BatchNorm's
    running statistics), AdamW's moments and counters, the generator."""
    return ([p.detach().clone() for p in opt.params],
            [b.clone() for b in model.buffers()],
            [t.clone() for t in opt.mu + opt.nu + opt.acc],
            (opt.count_t.clone(), opt.mini_step_t.clone()), gen.get_state())


def _full_restore(model, opt, gen, state):
    params, buffers, moments, (count, mini), rng = state
    with torch.no_grad():
        for t, v in zip(opt.params + list(model.buffers())
                        + opt.mu + opt.nu + opt.acc,
                        params + buffers + moments):
            t.copy_(v)
    opt.count_t.copy_(count)
    opt.mini_step_t.copy_(mini)
    gen.set_state(rng)


class _Masks:
    """Every keep-mask the models draw (dropout, DropPath, K4's), as
    returned to the caller: ``models.dropout.keep_mask`` and the names
    ``roberta`` and ``swin_v2`` import, a draw nested in another (a
    checkpointed layer's rewind) recorded once."""

    def __enter__(self):
        from mvuld_tpu_torch.models import dropout, roberta, swin_v2
        self.mods, self.inner = (dropout, roberta, swin_v2), dropout.keep_mask
        self.drawn, depth = [], [0]

        def keep(*a, **kw):
            depth[0] += 1
            try:
                out = self.inner(*a, **kw)
            finally:
                depth[0] -= 1
            if not depth[0]:
                self.drawn.append(out)
            return out

        for m in self.mods:
            m.keep_mask = keep
        return self.drawn

    def __exit__(self, *exc):
        for m in self.mods:
            m.keep_mask = self.inner


def _replay_equals_eager(model, opt, inputs, sb, gen, kernels=(), data=None,
                         label_smoothing=0.1):
    """``make_multi_train_step`` over ``sb`` ([K, B, ...] host arrays):
    the first call (K eager steps, then the capture), then from the state
    it leaves one replay against K eager steps (``capture=False``): the
    losses within fp32 relative 1e-6, the update and the BatchNorm running
    statistics (where the model has them) within relative L2 1e-5, every
    keep-mask to the bit. ``kernels``: wrappers that must launch in the
    capture and not in the replay."""
    from mvuld_tpu_torch.core.train_state import make_multi_train_step

    k = len(next(iter(sb.values())))
    indexed = data is not None
    step = make_multi_train_step(model, opt, k, label_smoothing, inputs,
                                 indexed=indexed)
    plain = make_multi_train_step(model, opt, k, label_smoothing, inputs,
                                  indexed=indexed, capture=False)
    with _Masks() as drawn:
        before = [f.launches for f in kernels]
        step(sb, gen, data)
        assert step.graph is not None
        assert all(f.launches > b for f, b in zip(kernels, before)), kernels
        captured = drawn[len(drawn) // 2:]
        del drawn[:]
        start = _full_state(model, opt, gen)
        eager = plain(sb, gen, data)
        eager_masks = list(drawn)
        after = _full_state(model, opt, gen)
        _full_restore(model, opt, gen, start)
        before = [f.launches for f in kernels]
        got = step(sb, gen, data)
    assert [f.launches for f in kernels] == before     # a replay is silent
    assert step.replays == 1
    torch.testing.assert_close(got["loss"], eager["loss"], rtol=1e-6, atol=0)
    assert len(captured) == len(eager_masks) > 0
    for a, b in zip(captured, eager_masks):
        assert torch.equal(a, b)

    def rel(now, want, ref):
        num = sum(float((a.double() - b.double()).norm() ** 2)
                  for a, b in zip(now, want)) ** 0.5
        den = sum(float((b.double() - c.double()).norm() ** 2)
                  for b, c in zip(want, ref)) ** 0.5
        assert den > 0
        return num / den

    assert rel([p.detach() for p in opt.params], after[0], start[0]) <= 1e-5
    names = [n for n, _ in model.named_buffers()]
    stats = [i for i, n in enumerate(names) if n.endswith(("running_mean",
                                                           "running_var"))]
    bufs = list(model.buffers())
    if stats:
        assert rel([bufs[i] for i in stats], [after[1][i] for i in stats],
                   [start[1][i] for i in stats]) <= 1e-5
    assert opt.count == 2 * k
    return bool(stats)


def _tiny_fusion_rows(n, rng):
    N, D, I = 12, 24, 40
    node_mask = np.zeros((n, N), np.float32)
    for b in range(n):
        node_mask[b, : rng.randint(2, N + 1)] = 1.0
    valid = (node_mask[:, :, None] > 0) & (node_mask[:, None, :] > 0)
    adj = rng.randint(0, 16, (n, N, N)).astype(np.uint8) * valid
    adj[:, np.arange(N), np.arange(N)] |= np.uint8(15)
    return {"img_emb": rng.randn(n, I).astype(np.float32),
            "text_emb": rng.randn(n, D).astype(np.float32),
            "node_emb": rng.randn(n, N, D).astype(np.float32)
            * node_mask[..., None],
            "pos": rng.rand(n, N, 4).astype(np.float32) * node_mask[..., None],
            "adj": adj.astype(np.uint8), "node_mask": node_mask,
            "label": rng.randint(0, 2, n).astype(np.int32)}


@pytest.mark.parametrize("indexed", [False, True], ids=["direct", "indexed"])
def test_multi_step_graph_fusion_head_equals_eager_steps(dev, indexed):
    """A captured K = 2 replay of a tiny ``multi_defect_new_gcn`` (dropout
    0.2, BatchNorm statistics from each batch) equals 2 eager steps from
    one saved state; ``indexed``: device-resident columns and index
    superbatches, as ``train_fusion`` feeds the head. It runs no kernel:
    the check is the capture and the statistics."""
    from mvuld_tpu_torch.config import default_config
    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.fusion_zoo import build_fusion_model
    from mvuld_tpu_torch.train.train_fusion import fusion_inputs

    model = build_fusion_model(None, "multi_defect_new_gcn", hidden=48,
                               img_dim=40, text_dim=24, num_rs_gcn=2,
                               num_hidden=2, max_nodes=12)
    init_jax_like(model, torch.Generator().manual_seed(0))
    model.to(dev)
    opt = build_optimizer(default_config(), lambda count: 1e-3, model)
    k, b = 2, 4
    rows = _tiny_fusion_rows(4 * k * b, np.random.RandomState(0))
    if indexed:
        data = {key: torch.as_tensor(v, device=dev) for key, v in
                rows.items()}
        sb = {"idx": np.random.RandomState(1).permutation(4 * k * b)[
            :k * b].astype(np.int32).reshape(k, b)}
    else:
        data = None
        sb = {key: v[:k * b].reshape(k, b, *v.shape[1:])
              for key, v in rows.items()}
    assert _replay_equals_eager(model, opt, fusion_inputs(0b0101), sb,
                                torch.Generator(device=dev).manual_seed(1),
                                data=data)


@pytest.mark.parametrize("text_remat", ["off", "on"])
def test_multi_step_graph_e2e_equals_eager_steps(dev, text_remat):
    """A captured K = 2 replay of a tiny e2e model in bf16 (K1/K2 and
    K3/K3b in SwinV2 with its first stage checkpointed, K4/K4b in the text
    encoder, the lines packed into 12 of 24 slots and drawing their masks
    over the slots, text dropout 0.1, DropPath 0.2, the fusion head's
    dropout and BatchNorms) equals 2 eager steps from one saved state;
    with ``text_remat`` on, the checkpointed text layers keep their masks
    inside the capture."""
    from types import SimpleNamespace

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.ops import fused_dense as fd
    from mvuld_tpu_torch.ops import window_attention as wa
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model

    opts = ["DATA.IMG_SIZE", 32, "MODEL.SWINV2.EMBED_DIM", 64,
            "MODEL.SWINV2.DEPTHS", [2, 2], "MODEL.SWINV2.NUM_HEADS", [2, 4],
            "MODEL.SWINV2.WINDOW_SIZE", 4,
            "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", [0, 0],
            "MODEL.DROP_PATH_RATE", 0.2, "MODEL.UNIXCODER.LAYERS", 2,
            "MODEL.UNIXCODER.HIDDEN", 64, "MODEL.UNIXCODER.HEADS", 2,
            "MODEL.UNIXCODER.INTERMEDIATE", 256, "DATA.FUNC_TOKENS", 24,
            "DATA.NODE_TOKENS", 8, "DATA.MAX_NODES", 6,
            "MODEL.MULTI.HIDDEN", 64, "MODEL.MULTI.NUM_RS_GCN", 1,
            "MODEL.MULTI.NUM_HIDDEN_FC", 1, "PARALLEL.DTYPE", "bfloat16",
            "TRAIN.FUSED_MLP", True, "TRAIN.USE_CHECKPOINT", True,
            "TRAIN.REMAT_STAGES", [0], "TRAIN.TEXT_REMAT", text_remat]
    cfg = get_config(SimpleNamespace(cfg=None, opts=opts, output="unused"))
    model = build_e2e_model(cfg, 64, node_capacity=12, use_pallas=True,
                            use_pallas_mlp=True, roberta_pallas_mlp=True)[0]
    assert model.text_encoder.config.dropout_rate == 0.1
    init_jax_like(model, torch.Generator().manual_seed(0))
    model.to(dev)
    opt = build_optimizer(cfg, lambda count: 1e-3, model)
    k, b, M, T, Tn = 2, 4, 6, 24, 8
    rng = np.random.RandomState(2)
    node_mask = (np.arange(M)[None, None] < rng.randint(2, M + 1, (k, b))[
        ..., None]).astype(np.float32)
    node_ids = rng.randint(3, 64, (k, b, M, Tn)).astype(np.int32)
    node_ids[..., 6:] = 1
    node_ids[node_mask == 0] = 1
    func_ids = rng.randint(3, 64, (k, b, T)).astype(np.int32)
    func_ids[..., T // 2:] = 1
    adj = np.tile(np.eye(M, dtype=np.uint8), (k, b, 1, 1))
    sb = {"func_ids": func_ids, "node_ids": node_ids,
          "image": rng.randn(k, b, 32, 32, 3).astype(np.float32),
          "pos": rng.rand(k, b, M, 4).astype(np.float32), "adj": adj,
          "node_mask": node_mask,
          "label": rng.randint(0, 2, (k, b)).astype(np.int32)}
    assert (node_mask.sum((1, 2)) > 12).any()      # some lines overflow
    from mvuld_tpu_torch.core.train_state import model_inputs
    assert _replay_equals_eager(
        model, opt, model_inputs, sb,
        torch.Generator(device=dev).manual_seed(3),
        kernels=(wa.window_attention_flat, wa.window_attention_flat_bwd,
                 fd.mlp_ln, fd.mlp_ln_bwd, fd.mlp_ln_res, fd.mlp_ln_res_bwd))



@pytest.mark.parametrize("bucket", [1, 4, 16])
def test_serve_packed_lines_match_every_slot(dev, bucket, monkeypatch):
    """``predict.serve`` of a tiny bf16 e2e model built without a
    ``node_capacity`` (K1/K3 in SwinV2, K4 in the text encoder): each
    chunk's valid lines packed at the host-counted capacity give the P(vul)
    of every line slot encoded within 2e-3, at buckets 1, 4 and 16."""
    from types import SimpleNamespace

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.ops import fused_dense as fd
    from mvuld_tpu_torch.train import predict
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model

    M, T, Tn, S = 40, 24, 8, 32
    opts = ["DATA.IMG_SIZE", S, "MODEL.SWINV2.EMBED_DIM", 64,
            "MODEL.SWINV2.DEPTHS", [2, 2], "MODEL.SWINV2.NUM_HEADS", [2, 4],
            "MODEL.SWINV2.WINDOW_SIZE", 4,
            "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", [0, 0],
            "MODEL.UNIXCODER.LAYERS", 2, "MODEL.UNIXCODER.HIDDEN", 64,
            "MODEL.UNIXCODER.HEADS", 2, "MODEL.UNIXCODER.INTERMEDIATE", 256,
            "DATA.FUNC_TOKENS", T, "DATA.NODE_TOKENS", Tn,
            "DATA.MAX_NODES", M, "MODEL.MULTI.HIDDEN", 64,
            "MODEL.MULTI.NUM_RS_GCN", 1, "MODEL.MULTI.NUM_HIDDEN_FC", 1,
            "PARALLEL.DTYPE", "bfloat16", "TRAIN.FUSED_MLP", True]
    cfg = get_config(SimpleNamespace(cfg=None, opts=opts, output="unused"))
    model = build_e2e_model(cfg, 64, use_pallas=True, use_pallas_mlp=True,
                            roberta_pallas_mlp=True)[0]
    gen = torch.Generator().manual_seed(0)
    init_jax_like(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.dtype))
    model.to(dev).eval()

    rng = np.random.RandomState(bucket)
    n = 2 * bucket
    counts = [17, 9] if bucket == 1 else rng.randint(5, M + 1, n)
    node_mask = (np.arange(M)[None] < np.asarray(counts)[:, None]).astype(
        np.float32)
    node_ids = rng.randint(3, 64, (n, M, Tn)).astype(np.int32)
    node_ids[..., 6:] = 1
    node_ids[node_mask == 0] = 1
    func_ids = rng.randint(3, 64, (n, T)).astype(np.int32)
    func_ids[:, T // 2:] = 1
    both = node_mask[:, :, None] * node_mask[:, None, :] > 0
    adj = ((rng.rand(n, M, M) < 0.3) & both) | (np.eye(M, dtype=bool) & both)
    arrs = {"func_ids": func_ids, "node_ids": node_ids,
            "image": rng.randn(n, S, S, 3).astype(np.float32),
            "pos": (rng.rand(n, M, 4) * node_mask[..., None]).astype(
                np.float32),
            "adj": adj.astype(np.uint8), "node_mask": node_mask}

    predict.reset_line_counters()
    before = fd.mlp_ln_res.launches
    got = predict.serve(model, arrs, bucket, dev)
    assert fd.mlp_ln_res.launches > before
    c = predict.line_counters()
    assert c["lines"] <= c["encoded"] < c["slots"], c
    monkeypatch.setattr(predict, "line_rows", lambda valid, slots: slots)
    want = predict.serve(model, arrs, bucket, dev)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 2e-3

def test_multi_step_graph_swin_moe_replay_equals_eager_to_the_bit(dev):
    """A captured K = 8 replay of a tiny Swin-MoE as its yaml configures
    the routing (4 experts, BPR, the load-importance loss, gate noise 1.0,
    MOE_DROP 0.1, no fc2 bias; DropPath 0.1; bf16), built by
    ``train_swin.build_swin_training``, equals 8 eager steps from one saved
    state to the bit: the losses, every parameter, Adam's moments and the
    routing counters. The capture is the check that no host
    synchronisation sits in the step (BPR's sort, the slots, the counters,
    the aux loss): one would raise inside it. Deterministic algorithms are
    on (the bias table's and the convolution's gradients sum without
    atomics), so that any difference is the capture's."""
    from types import SimpleNamespace

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.models.moe import routing_counters
    from mvuld_tpu_torch.train.train_swin import build_swin_training

    opts = ["MODEL.TYPE", "swin_moe", "DATA.IMG_SIZE", 64,
            "MODEL.SWIN_MOE.EMBED_DIM", 32, "MODEL.SWIN_MOE.DEPTHS", [2, 2, 2],
            "MODEL.SWIN_MOE.NUM_HEADS", [2, 4, 4],
            "MODEL.SWIN_MOE.WINDOW_SIZE", 4,
            "MODEL.SWIN_MOE.MOE_BLOCKS", [[1], [-1], [0, 1]],
            "MODEL.SWIN_MOE.NUM_LOCAL_EXPERTS", 4,
            "MODEL.SWIN_MOE.CAPACITY_FACTOR", 1.0,
            "MODEL.SWIN_MOE.USE_BPR", True,
            "MODEL.SWIN_MOE.IS_GSHARD_LOSS", False,
            "MODEL.SWIN_MOE.GATE_NOISE", 1.0, "MODEL.SWIN_MOE.MOE_DROP", 0.1,
            "MODEL.SWIN_MOE.MLP_FC2_BIAS", False,
            "MODEL.DROP_PATH_RATE", 0.1, "MODEL.NUM_CLASSES", 2,
            "PARALLEL.DTYPE", "bfloat16", "AUG.MIXUP", 0.0, "AUG.CUTMIX", 0.0,
            "TRAIN.FUSED_STEPS", 8, "DATA.BATCH_SIZE", 4, "SEED", 0]
    cfg = get_config(SimpleNamespace(cfg=None, opts=opts, output="unused"))
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        run = build_swin_training(cfg, dev, steps_per_epoch=8)
        model, opt = run.model, run.opt
        k = 8
        rng = np.random.RandomState(0)
        sb = {"image": rng.randn(k, 4, 64, 64, 3).astype(np.float32),
              "label": rng.randint(0, 2, (k, 4)).astype(np.int32)}
        gen = torch.Generator(device=dev).manual_seed(1)
        step, plain = run.multi_step(k), run.multi_step(k, capture=False)
        step(sb, gen)
        assert step.graph is not None
        start = _full_state(model, opt, gen)
        eager = plain(sb, gen)
        after = _full_state(model, opt, gen)
        counts = routing_counters(model)
        _full_restore(model, opt, gen, start)
        got = step(sb, gen)
        now = _full_state(model, opt, gen)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = cudnn
    assert step.replays == 1 and opt.count == 2 * k
    assert torch.equal(got["loss"], eager["loss"])
    assert 0 < counts["kept"] < counts["routed"]
    assert routing_counters(model) == counts
    for a, b in zip(now[0] + now[1] + now[2], after[0] + after[1] + after[2]):
        assert torch.equal(a, b)
    assert not torch.equal(now[0][0], start[0][0])
