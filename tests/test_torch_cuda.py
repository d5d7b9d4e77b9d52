"""The CUDA kernels against their plain versions, on the card.

Each test skips when no CUDA device is present (decided in the ``dev``
fixture, never at import). On the card (``tests/conftest.py`` imports JAX,
which the GPU machine need not have):
  python -m pytest --noconftest tests/test_torch_cuda.py -q
Kernels: K1, K2, K5 (flat attention; K2 and K5 also at the model's
windows, twice to the bit, on misaligned views, on an underflowing row and
with ``mxu_bf16``; K2 from K1's outputs), K7/K7b (map layout), K8/K8b
(head layout with a mask operand; the three forwards K1, K7, K8 also at
the model's windows, twice to the bit, on misaligned views, with
``mxu_bf16``, K1 on an underflowing row), K3/K3b, K4/K4b (MLP + LayerNorm: bf16 and fp32 x, the model's
shapes, ragged rows, misaligned views, a backward that repeats to the
bit), K6/K6b (dense with its epilogue, bf16 and fp32, at the GEMM core's
tile edges, blockbench's shapes and a 3072-wide LayerNorm; a backward that
repeats to the bit), and ``make_multi_train_step``'s CUDA graph: K replayed steps of a
tiny SwinV2 through K1/K2/K3/K3b (DropPath and, in one case, dropout in
a checkpointed stage) against K eager steps from the same state, and its
refusal under a gloo group. Tolerances: fp32
outputs 1e-4 (both compute in fp32, another summation order; the fp32 MLP
and dense kernels from two-term bf16 products); bf16 outputs two bf16 ulps
at the largest value (both round one fp32 result to bf16).
"""

import math

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
# the published window): (ws, Bn per image grid 2×2, H)
LARGE_WINDOWS = [(14, 2), (28, 2)]


@pytest.mark.parametrize("layout", ["head_bf16", "head_fp32", "map_bf16",
                                    "map_bf16_mxu"])
@pytest.mark.parametrize("ws,H", LARGE_WINDOWS, ids=["ws14", "ws28"])
def test_backward_kernels_at_the_model_windows(dev, ws, H, layout):
    """K8b (mask operand, bf16 in / bf16 out and fp32 / fp32) and K7b
    (synthesised mask, bf16 in / fp32 out, with and without ``mxu_bf16``) at
    N = 196 and 784 on a shifted 2×2 grid of windows."""
    from mvuld_tpu_torch.ops import window_attention as wa
    N, hd, shift = ws * ws, 32, ws // 2
    dtype = torch.float32 if layout == "head_fp32" else torch.bfloat16
    g, bias, ls = _attn_inputs(dev, 20, H, N, dtype)
    qkv = torch.randn(1, 2 * ws, 2 * ws, 3, H, hd, device=dev, generator=g
                      ).to(dtype)
    gout = torch.randn(1, 2 * ws, 2 * ws, H, hd, device=dev, generator=g)
    if layout.startswith("map"):
        mxu = layout.endswith("mxu")
        got = wa.window_attention_map_bwd(qkv, bias, ls, gout, shift, mxu)
        want = wa.window_attention_map_bwd_plain(qkv, bias, ls, gout, shift,
                                                 mxu)
        rel = 2.0 ** -6 if mxu else 1e-4
        tols = [r * float(w.abs().max())
                for r, w in zip((rel, rel, max(rel, 1e-3)), want)]
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
# on a 2×2 grid of windows, bf16 and fp32. Tolerances as every backward's:
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
@pytest.mark.parametrize("ws", [14, 28])
def test_flat_backward_kernels_at_the_model_windows(dev, ws, shifted, dtype,
                                                    kind):
    from mvuld_tpu_torch.ops import window_attention as wa
    geom = (ws // 2, 2, 2) if shifted else (0, 1, 1)
    qkv, bias, ls, gout = _flat_inputs(dev, 30, 8, ws, 2, dtype)
    counter = (wa.window_attention_flat_bwd_v1 if kind == "k5"
               else wa.window_attention_flat_bwd)
    before = counter.launches
    got = _flat_grads(kind, qkv, bias, ls, gout, geom)
    want = _flat_grads(kind, qkv, bias, ls, gout, geom, plain=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got[0].dtype == dtype and got[0].shape == qkv.shape
    got, want = _split_dqkv(got), _split_dqkv(want)
    for a, b, t in zip(got, want, _grad_tols(want, dtype)):
        assert torch.isfinite(a).all()
        assert float((a.float() - b.float()).abs().max()) <= t
    if kind == "k5":     # the same function as K2 (see the v1 test above)
        k2 = _split_dqkv(_flat_grads("k2", qkv, bias, ls, gout, geom))
        lim = 1e-4 if dtype == torch.float32 else 2e-2
        assert max(_rel_l2(a, b) for a, b in zip(got, k2)) <= lim


@pytest.mark.parametrize("kind", ["k2", "k5"])
def test_flat_backward_repeats_to_the_bit(dev, kind):
    """No atomics: two runs give the same bits (the windows summed into
    dbias in chunks, then in a fixed order)."""
    qkv, bias, ls, gout = _flat_inputs(dev, 31, 16, 14, 2, torch.bfloat16)
    first = _flat_grads(kind, qkv, bias, ls, gout, (7, 2, 2))
    again = _flat_grads(kind, qkv, bias, ls, gout, (7, 2, 2))
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


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
def test_flat_backward_from_the_forward_kernel(dev, dtype):
    """K2 from the new K1's output and row sums: within the backward's
    tolerances of the plain backward fed the same (o, r); against the plain
    backward fed the plain forward's (o, r) within those tolerances in fp32
    and within relative L2 2e-2 in bf16, where a bf16 o may sit one rounding
    step from the plain forward's and t = rowsum(g·o) moves with it."""
    from mvuld_tpu_torch.ops import window_attention as wa
    qkv, bias, ls, gout = _flat_inputs(dev, 46, 8, 14, 2, dtype)
    geom = (7, 2, 2)
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


def _train_state(run, gen):
    opt = run.opt
    return ([p.detach().clone() for p in opt.params],
            [t.clone() for t in opt.mu + opt.nu],
            opt.count_t.clone(), gen.get_state())


def _restore(run, gen, state):
    opt = run.opt
    params, moments, count, rng = state
    with torch.no_grad():
        for p, v in zip(opt.params, params):
            p.copy_(v)
        for t, v in zip(opt.mu + opt.nu, moments):
            t.copy_(v)
    opt.count_t.copy_(count)
    gen.set_state(rng)


@pytest.mark.parametrize("drop_rate", [0.0, 0.1], ids=["droppath",
                                                      "dropout_remat"])
def test_multi_step_graph_replay_equals_eager_steps(dev, drop_rate):
    """One replay of the captured K = 3 steps from a saved state (the
    parameters, AdamW's moments, the device count and the generator) equals
    3 eager steps from it: the DropPath masks to the bit, the losses within
    fp32 relative 1e-6 and the parameter update within relative L2 1e-5
    (the same kernels in the same order; a library backward that sums with
    atomics may move last bits). K1 and K2 run, and at rate 0 K3 and K3b
    (dropout takes the MLP off the fused kernel, as in JAX)."""
    import numpy as np

    from mvuld_tpu_torch.models import swin_v2
    from mvuld_tpu_torch.ops import fused_dense as fd
    from mvuld_tpu_torch.ops import window_attention as wa

    run = _tiny_swin_training(dev, drop_rate)
    k = 3
    rng = np.random.RandomState(0)
    sb = {"image": rng.randn(k, 4, 32, 32, 3).astype(np.float32),
          "label": rng.randint(0, 2, (k, 4)).astype(np.int32)}
    gen = torch.Generator(device=dev).manual_seed(1)
    step = run.multi_step(k)
    kernels = [wa.window_attention_flat, wa.window_attention_flat_bwd,
               fd.mlp_ln, fd.mlp_ln_bwd]
    drawn = []
    inner = swin_v2.keep_mask

    def keep(*a):
        drawn.append(inner(*a))
        return drawn[-1]

    swin_v2.keep_mask = keep
    try:
        start_counts = [f.launches for f in kernels]
        step(sb, gen)                       # eager warm-up, then capture
        before = [f.launches for f in kernels]
        ran = [b - a > 0 for a, b in zip(start_counts, before)]
        assert step.graph is not None
        assert ran == [True, True] + [drop_rate == 0.0] * 2, ran
        start = _train_state(run, gen)
        n = len(drawn)
        eager = [run.step({key: torch.as_tensor(v[i], device=dev)
                           for key, v in sb.items()}, gen)
                 for i in range(k)]
        eager_masks = drawn[n:]
        eager_params = [p.detach().clone() for p in run.opt.params]
        _restore(run, gen, start)
        before = [f.launches for f in kernels]
        got = step(sb, gen)
    finally:
        swin_v2.keep_mask = inner
    assert [f.launches for f in kernels] == before     # a replay is silent
    assert step.replays == 1
    torch.testing.assert_close(got["loss"],
                               torch.stack([m["loss"] for m in eager]),
                               rtol=1e-6, atol=0)
    captured = drawn[n // 2:n]               # the masks the capture drew
    assert len(captured) == len(eager_masks) > 0
    for a, b in zip(captured, eager_masks):
        assert torch.equal(a, b)
    num = sum(float((p.detach() - e).float().norm() ** 2)
              for p, e in zip(run.opt.params, eager_params)) ** 0.5
    den = sum(float((e - s).float().norm() ** 2)
              for e, s in zip(eager_params, start[0])) ** 0.5
    assert den > 0 and num <= 1e-5 * den, (num, den)
    assert run.opt.count == 2 * k


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
