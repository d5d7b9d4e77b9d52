"""The CUDA kernels against their plain versions, on the card.

Each test skips when no CUDA device is present (decided in the ``dev``
fixture, never at import). On the card (``tests/conftest.py`` imports JAX,
which the GPU machine need not have):
  python -m pytest --noconftest tests/test_torch_cuda.py -q
Kernels: K1, K2, K5 (flat attention), K7/K7b (map layout), K8/K8b (head
layout with a mask operand), K3/K3b, K4/K4b (MLP + LayerNorm), K6/K6b
(dense with its epilogue). Tolerances: fp32 attention 1e-4 (both compute
in fp32, another summation order); bf16 outputs two bf16 ulps at the
largest value (both round one fp32 result to bf16).
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


def test_mlp_ln_kernel_rejects_fp32(dev):
    from mvuld_tpu_torch.ops.fused_dense import mlp_ln
    x = torch.zeros(4, 16, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        mlp_ln(x, torch.zeros(16, 128), torch.zeros(128), torch.zeros(128, 16),
               torch.zeros(16), torch.ones(16), torch.zeros(16))


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


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


# (Bn, ws, nW of the mask or 0): N not a multiple of the 64-row tile, fewer
# mask windows than windows
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
