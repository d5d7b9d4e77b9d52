"""The port's plain K1 (``window_attention_flat_plain``) against the JAX
Pallas kernel ``pallas_window_attention_flat`` in interpret mode; below it
the head layout (K8/K8b) and the map layout (K7/K7b) against their Pallas
kernels in interpret mode, autograd through the port's two entry points
against ``jax.grad`` of the JAX references, and the card kernels'
split-operand arithmetic (``_core_bwd_split`` for K7b/K8b,
``_flat_bwd_split`` for K2/K5, ``_core_fwd_split`` for K7/K8,
``_flat_fwd_split`` for K1) against the Pallas kernels.

Both compute the kernel numerics (rsqrt normalisation, fixed per-head
softmax shift, row sums clamped at 1e-30, the shift mask from the window
id), so they agree to 1e-5 in fp32. On the CPU the wrapper
``window_attention_flat`` is the plain version; the CUDA kernel is held
against it on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu.models.swin_v2 import shifted_window_mask
from mvuld_tpu.ops import window_attention as jwa
from mvuld_tpu.ops.window_attention import pallas_window_attention_flat
from mvuld_tpu_torch.ops import window_attention as twa
from mvuld_tpu_torch.ops.window_attention import (window_attention_flat,
                                                  window_attention_flat_plain)
from jax_reference import no_persistent_compile_cache  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, Bn=8, ws=4, heads=2, hd=8):
    rng = np.random.RandomState(seed)
    N, C = ws * ws, heads * hd
    qkv = rng.randn(Bn, N, 3 * C).astype(np.float32)
    bias = rng.randn(heads, N, N).astype(np.float32)
    scale = np.exp(rng.rand(heads).astype(np.float32))
    return qkv, bias, scale


def _both(qkv, bias, scale, **geom):
    want = np.asarray(pallas_window_attention_flat(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(scale),
        interpret=True, **geom))
    got = window_attention_flat(torch.as_tensor(qkv), torch.as_tensor(bias),
                                torch.as_tensor(scale), **geom)
    return got.numpy(), want


@pytest.mark.parametrize("geom", [dict(), dict(shift=2, nWh=2, nWw=2)],
                         ids=["shift0", "shift2_grid2x2"])
def test_plain_matches_pallas_interpret(geom):
    """8 windows = 2 images of the 2×2 grid; the shifted case exercises the
    boundary-window masks (last row, last column, corner)."""
    got, want = _both(*_inputs(seed=3), **geom)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_wide_bias_range():
    """Bias range ≈ 40 per head (the JAX test of the same name)."""
    qkv, bias, scale = _inputs(seed=7)
    got, want = _both(qkv, (bias * 12.0).astype(np.float32), scale)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_underflow_row_sum_finite():
    """Scale 95 and a wide bias flush whole rows of exp(s − m) to zero; the
    clamped row sum keeps the output finite, as in the Pallas kernel. The
    scale multiplies the fp32 rounding of q·k (summed in another order on
    each side) by 95, so the relative tolerance here is 1e-4."""
    qkv, bias, scale = _inputs(seed=11)
    got, want = _both(qkv, (bias * 10.0).astype(np.float32),
                      np.full_like(scale, 95.0))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_plain_bf16_keeps_dtype():
    qkv, bias, scale = _inputs(seed=5)
    q16 = torch.as_tensor(qkv).bfloat16()
    out = window_attention_flat_plain(q16, torch.as_tensor(bias),
                                      torch.as_tensor(scale), 2, 2, 2)
    assert out.dtype == torch.bfloat16 and out.shape == (8, 16, 16)


@pytest.mark.parametrize("bad", [
    dict(qkv=(8, 15, 48)),                           # N not a square
    dict(bias=(2, 16, 15)),                          # bias shape
    dict(qkv=(8, 16, 45)),                           # C not divisible by H
    dict(geom=dict(shift=2)),                        # shift without a grid
    dict(qkv=(6, 16, 48), geom=dict(shift=2, nWh=2, nWw=2)),  # Bn % nW
    dict(scale=3),                                   # one scale per head
], ids=["nonsquare", "bias", "heads", "nogrid", "windows", "scales"])
def test_geometry_errors_raise(bad):
    qkv = torch.zeros(bad.get("qkv", (8, 16, 48)))
    bias = torch.zeros(bad.get("bias", (2, 16, 16)))
    scale = torch.ones(bad.get("scale", 2))
    with pytest.raises(ValueError):
        window_attention_flat(qkv, bias, scale, **bad.get("geom", {}))
    with pytest.raises(ValueError):
        window_attention_flat_plain(qkv, bias, scale, **bad.get("geom", {}))


# ------------------------------------------------ head layout: K8 / K8b
# fp32 throughout: forward within 1e-5, gradients within 1e-4 (dbias and
# dscale are sums over every window in another order).
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _head_inputs(seed, Bn=4, H=2, N=16, hd=8):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(Bn, H, N, hd).astype(np.float32)
                  for _ in range(4))
    bias = rng.randn(H, N, N).astype(np.float32)
    scale = np.exp(rng.rand(H).astype(np.float32))
    return q, k, v, bias, scale, g


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _shift_mask():
    return np.asarray(shifted_window_mask(8, 8, 4, 2), np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_head_layout_plain_matches_pallas_interpret(masked):
    q, k, v, bias, scale, _ = _head_inputs(21)
    mask = _shift_mask() if masked else None
    want = np.asarray(jwa.pallas_window_attention(
        *map(jnp.asarray, (q, k, v, bias, scale)), mask, interpret=True))
    got = twa.window_attention_fwd(*_t(q, k, v, bias, scale), mask)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_head_layout_bwd_plain_matches_pallas_interpret(masked):
    q, k, v, bias, scale, g = _head_inputs(22)
    mask = _shift_mask() if masked else None
    want = jwa.pallas_window_attention_bwd(
        *map(jnp.asarray, (q, k, v, bias, scale, g)), mask, interpret=True)
    got = twa.window_attention_bwd(*_t(q, k, v, bias, scale, g), mask)
    for name, a, b in zip(("dq", "dk", "dv", "dbias", "dscale"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD_TOL)


def test_head_layout_autograd_matches_jax_grad():
    """``window_attention`` differentiates through the written-out backward
    (K8b's plain version on the CPU); the reference is ``jax.grad`` of
    ``window_attention_reference`` with the same mask and cotangent."""
    q, k, v, bias, scale, g = _head_inputs(23)
    mask = _shift_mask()
    want = jax.grad(lambda *a: jnp.sum(
        jwa.window_attention_reference(*a, mask) * g), argnums=(0, 1, 2, 3, 4)
    )(*map(jnp.asarray, (q, k, v, bias, scale)))
    leaves = [t.requires_grad_() for t in _t(q, k, v, bias, scale)]
    out = twa.window_attention(*leaves, mask)
    got = torch.autograd.grad((out * torch.as_tensor(g)).sum(), leaves)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_head_layout_bf16_keeps_dtype_and_rounds_p():
    q, k, v, bias, scale, g = _head_inputs(24)
    q16, k16, v16 = (t.bfloat16() for t in _t(q, k, v))
    out = twa.window_attention_plain(q16, k16, v16, *_t(bias, scale))
    assert out.dtype == torch.bfloat16
    want = np.asarray(jwa.window_attention_reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(bias), jnp.asarray(scale)).astype(jnp.float32))
    # both round p and the output to bf16; two bf16 ulps of the largest
    assert np.abs(out.float().numpy() - want).max() <= 2 ** -6 * np.abs(want).max()
    grads = twa.window_attention_bwd_plain(q16, k16, v16, *_t(bias, scale),
                                           torch.as_tensor(g).bfloat16())
    assert [t.dtype for t in grads] == [torch.bfloat16] * 3 + [torch.float32] * 2


# ------------------------------------------------- map layout: K7 / K7b

def _map_inputs(seed, B=2, Hp=8, Wp=8, H=2, hd=8, ws=4):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, Hp, Wp, 3, H, hd).astype(np.float32)
    bias = rng.randn(H, ws * ws, ws * ws).astype(np.float32)
    scale = np.exp(rng.rand(H).astype(np.float32))
    g = rng.randn(B, Hp, Wp, H, hd).astype(np.float32)
    return qkv, bias, scale, g


MAP_CASES = [(0, np.float32, False), (2, np.float32, False),
             (2, jnp.bfloat16, False), (2, np.float32, True)]
MAP_IDS = ["shift0", "shift2", "shift2_bf16_in", "shift2_mxu_bf16"]


@pytest.mark.parametrize("shift,dtype,mxu", MAP_CASES, ids=MAP_IDS)
def test_map_layout_plain_matches_pallas_interpret(shift, dtype, mxu):
    """fp32 output whatever the input dtype. With ``mxu_bf16`` both sides
    round q̂, k̂, p and v to bf16 before the products; a value on a rounding
    boundary may go either way, so the tolerance there is one bf16 ulp of
    the largest output (2⁻⁸ relative)."""
    qkv, bias, scale, _ = _map_inputs(31)
    jq = jnp.asarray(qkv, dtype)
    want = jwa.pallas_window_attention_map(
        jq, jnp.asarray(bias), jnp.asarray(scale), shift, interpret=True,
        mxu_bf16=mxu)
    tq = torch.as_tensor(np.array(jq.astype(jnp.float32)))
    tq = tq.bfloat16() if dtype is not np.float32 else tq
    got = twa.window_attention_map_fwd(tq, *_t(bias, scale), shift, mxu)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    tol = dict(atol=2 ** -8 * float(np.abs(want).max()), rtol=0) if mxu else TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("shift,dtype,mxu", MAP_CASES, ids=MAP_IDS)
def test_map_layout_bwd_plain_matches_pallas_interpret(shift, dtype, mxu):
    qkv, bias, scale, g = _map_inputs(32)
    jq = jnp.asarray(qkv, dtype)
    want = jwa.pallas_window_attention_map_bwd(
        jq, jnp.asarray(bias), jnp.asarray(scale), jnp.asarray(g), shift,
        interpret=True, mxu_bf16=mxu)
    tq = torch.as_tensor(np.array(jq.astype(jnp.float32)))
    tq = tq.bfloat16() if dtype is not np.float32 else tq
    got = twa.window_attention_map_bwd(tq, *_t(bias, scale, g), shift, mxu)
    assert got[0].dtype == torch.float32 and got[0].shape == qkv.shape
    for name, a, b in zip(("dqkv", "dbias", "dscale"), got, want):
        b = np.asarray(b)
        tol = (dict(atol=2 ** -7 * float(np.abs(b).max()), rtol=0) if mxu
               else GRAD_TOL)
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **tol)


@pytest.mark.parametrize("shift", [0, 2])
def test_map_layout_autograd_matches_jax_grad(shift):
    """``window_attention_map`` casts K7b's fp32 dqkv back to qkv's dtype;
    the reference is ``jax.grad`` of ``window_attention_map_reference`` with
    the shifted-window mask of the rolled map."""
    qkv, bias, scale, g = _map_inputs(33)
    mask = _shift_mask() if shift else None
    want = jax.grad(lambda *a: jnp.sum(
        jwa.window_attention_map_reference(*a, mask) * g), argnums=(0, 1, 2)
    )(*map(jnp.asarray, (qkv, bias, scale)))
    leaves = [t.requires_grad_() for t in _t(qkv, bias, scale)]
    out = twa.window_attention_map(*leaves, shift)
    got = torch.autograd.grad((out * torch.as_tensor(g)).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    q16 = torch.as_tensor(qkv).bfloat16().requires_grad_()
    out = twa.window_attention_map(q16, *_t(bias, scale), shift)
    assert out.dtype == torch.float32
    (dq,) = torch.autograd.grad(out.sum(), q16)
    assert dq.dtype == torch.bfloat16


def test_map_synthesised_mask_equals_mask_operand():
    """K7's plain version (mask from the window's grid position) and K8's
    (the ``window_region_mask`` operand) on the same numbers re-laid, forward
    and backward; and that mask is the model's ``shifted_window_mask``."""
    qkv, bias, scale, g = _map_inputs(34)
    tq, tb, ts, tg = _t(qkv, bias, scale, g)
    mask = twa.window_region_mask(4, 2, 2, 2)
    np.testing.assert_array_equal(mask, _shift_mask())
    q, k, v = twa._map_to_windows(tq, 4)
    out_map = twa.window_attention_map_plain(tq, tb, ts, 2)
    out_head = twa.window_attention_plain(q, k, v, tb, ts, mask)
    np.testing.assert_allclose(
        twa._windows_to_map(out_head, 2, 8, 8, 4).numpy(), out_map.numpy(),
        atol=1e-6)
    dqkv, dbias, dscale = twa.window_attention_map_bwd_plain(tq, tb, ts, tg, 2)
    dq, dk, dv, dbias_h, dscale_h = twa.window_attention_bwd_plain(
        q, k, v, tb, ts, twa._heads_map_to_windows(tg, 4), mask)
    np.testing.assert_allclose(
        twa._windows_to_map(torch.stack([dq, dk, dv]), 2, 8, 8, 4).numpy(),
        dqkv.numpy(), atol=1e-6)
    np.testing.assert_allclose(dbias_h.numpy(), dbias.numpy(), atol=1e-5)
    np.testing.assert_allclose(dscale_h.numpy(), dscale.numpy(), atol=1e-5)


def test_mxu_bf16_env_default(monkeypatch):
    qkv, bias, scale, _ = _map_inputs(35)
    args = _t(qkv, bias, scale)
    plain = twa.window_attention_map_plain(*args, 2)
    monkeypatch.setenv("MVULD_ATTN_MXU_BF16", "1")
    rounded = twa.window_attention_map_plain(*args, 2)
    assert torch.equal(rounded, twa.window_attention_map_plain(
        *args, 2, mxu_bf16=True))
    assert not torch.equal(rounded, plain)


# ------------------------------- the card kernels' split-operand arithmetic
# K8b/K7b form every fp32 product on the card as a few bf16 tensor-core
# products of split operands. ``_core_bwd_split`` is that arithmetic in plain
# PyTorch; here it is held against the Pallas kernels (fp32 products) with
# the tolerances the kernels are held to on the card: fp32 dq/dk/dv within
# 1e-4 of the largest value, dbias 1e-4, dscale 1e-3, bf16 outputs within two
# bf16 ulps of the largest. ``scale`` 100 is the logit scale at its clamp,
# where an error in q̂·k̂ weighs most.

def _assert_card_tolerances(got, want, out_bf16):
    *first, dbias, dscale = zip(got, want)
    rel_first = 2.0 ** -6 if out_bf16 else 1e-4
    for (a, b), rel in [*((ab, rel_first) for ab in first), (dbias, 1e-4),
                        (dscale, 1e-3)]:
        a = a.float().numpy()
        b = np.asarray(b.astype(jnp.float32))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * np.abs(b).max()


SPLIT_CASES = [(masked, bf16, scale) for masked in (False, True)
               for bf16 in (False, True) for scale in (None, 100.0)]
SPLIT_IDS = [f"{'mask' if m else 'nomask'}_{'bf16' if b else 'fp32'}_"
             f"{'scale100' if s else 'scale1'}" for m, b, s in SPLIT_CASES]


@pytest.mark.parametrize("masked,bf16,scale100", SPLIT_CASES, ids=SPLIT_IDS)
def test_head_layout_split_products_match_pallas_interpret(masked, bf16,
                                                           scale100):
    q, k, v, bias, scale, g = _head_inputs(41, hd=32)
    if scale100:
        scale = np.full_like(scale, scale100)
    mask = _shift_mask() if masked else None
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    want = jwa.pallas_window_attention_bwd(
        jq, jk, jv, jnp.asarray(bias), jnp.asarray(scale), jg, mask,
        interpret=True)
    tq, tk, tv, tg = _t(*(np.array(a.astype(jnp.float32))
                         for a in (jq, jk, jv, jg)))
    got = twa._core_bwd_split(tq, tk, tv, *_t(bias, scale),
                              twa._mask_tensor(mask, tq.device), tg, bf16, bf16)
    if bf16:
        got = [t.bfloat16() for t in got[:3]] + list(got[3:])
    _assert_card_tolerances(got, want, bf16)


@pytest.mark.parametrize("masked,bf16,scale100", SPLIT_CASES, ids=SPLIT_IDS)
def test_map_layout_split_products_match_pallas_interpret(masked, bf16,
                                                          scale100):
    """The map layout: the mask synthesised from the shift, fp32 g and dqkv
    whatever qkv's type (so g takes two terms, v one when qkv is bf16)."""
    qkv, bias, scale, g = _map_inputs(42, hd=32)
    if scale100:
        scale = np.full_like(scale, scale100)
    shift = 2 if masked else 0
    jq = jnp.asarray(qkv, jnp.bfloat16 if bf16 else jnp.float32)
    want = jwa.pallas_window_attention_map_bwd(
        jq, jnp.asarray(bias), jnp.asarray(scale), jnp.asarray(g), shift,
        interpret=True)
    tq, tb, ts, tg = _t(np.array(jq.astype(jnp.float32)), bias, scale, g)
    dq, dk, dv, dbias, dscale = twa._core_bwd_split(
        *twa._map_to_windows(tq, 4), tb, ts, twa._map_mask(tq, 4, shift, 8, 8),
        twa._heads_map_to_windows(tg, 4), bf16, False)
    dqkv = twa._windows_to_map(torch.stack([dq, dk, dv]), 2, 8, 8, 4)
    assert dqkv.shape == qkv.shape
    _assert_card_tolerances([dqkv, dbias, dscale], want, False)


# K2 and K5 run the same passes with the flat layout's fixed-shift softmax.
# ``_flat_bwd_split`` is their arithmetic (K2's row terms from the forward's
# output and row sums, K5's from a fixed-shift row pass), held against the
# Pallas K2 (``pallas_window_attention_flat_bwd2``, fed the Pallas forward's
# output and row sums) and K5 (``pallas_window_attention_flat_bwd``) at the
# card's tolerances: fp32 dq, dk, dv within 1e-4 of their largest value,
# bf16 ones within two bf16 ulps, dbias 1e-4, dscale 1e-3; with
# ``mxu_bf16`` (one product per term, the Pallas kernels round the same
# operands, and K5's dv rounds e and r·g where the kernel rounds p and g)
# two bf16 ulps for dq, dk, dv, dbias 1e-3, dscale 1e-2, the card's
# ``mxu_bf16`` tolerances.

def _flat_inputs(seed, Bn=8, ws=4, heads=2, hd=32):
    rng = np.random.RandomState(seed)
    N, C = ws * ws, heads * hd
    return (rng.randn(Bn, N, 3 * C).astype(np.float32),
            rng.randn(heads, N, N).astype(np.float32),
            np.exp(rng.rand(heads)).astype(np.float32),
            rng.randn(Bn, N, C).astype(np.float32))


def _flat_split_against_pallas(kind, shift, bf16, scale100, mxu):
    qkv, bias, scale, g = _flat_inputs(44)
    if scale100:
        scale = np.full_like(scale, scale100)
    geom = dict(shift=shift, nWh=2, nWw=2) if shift else {}
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jq, jg, jb, js = (jnp.asarray(qkv, jdt), jnp.asarray(g, jdt),
                      jnp.asarray(bias), jnp.asarray(scale))
    tq, tg = (torch.as_tensor(np.array(a.astype(jnp.float32)))
              for a in (jq, jg))
    if bf16:
        tq, tg = tq.bfloat16(), tg.bfloat16()
    tb, ts = _t(bias, scale)
    Bn, N, C = g.shape
    if kind == "k2":
        jo, jr = jwa.pallas_window_attention_flat(
            jq, jb, js, interpret=True, return_rowsum=True, out_dtype=jdt,
            mxu_bf16=mxu, **geom)
        want = jwa.pallas_window_attention_flat_bwd2(
            jq, jb, js, jo, jr, jg, interpret=True, mxu_bf16=mxu, **geom)
        to = torch.as_tensor(np.array(jo.astype(jnp.float32))).to(tq.dtype)
        tr = torch.as_tensor(np.array(jr)).permute(1, 0, 2, 3).reshape(
            Bn, -1, N)
        got = twa._flat_bwd_split(tq, tb, ts, tg, **geom, o=to, r=tr,
                                  mxu_bf16=mxu)
    else:
        want = jwa.pallas_window_attention_flat_bwd(
            jq, jb, js, jg, interpret=True, mxu_bf16=mxu, **geom)
        got = twa._flat_bwd_split(tq, tb, ts, tg, **geom, mxu_bf16=mxu)
    dqkv = got[0].to(tq.dtype)
    got = [dqkv[..., i * C:(i + 1) * C] for i in range(3)] + list(got[1:])
    if mxu:
        for (a, b), rel in zip(zip(got, want), [2.0 ** -6] * 3 + [1e-3, 1e-2]):
            b = np.asarray(b.astype(jnp.float32))
            assert np.abs(a.float().numpy() - b).max() <= rel * np.abs(b).max()
    else:
        _assert_card_tolerances(got, want, bf16)


FLAT_SPLIT_CASES = [(kind, shift, bf16, scale) for kind in ("k2", "k5")
                    for shift in (0, 2) for bf16 in (False, True)
                    for scale in (None, 100.0)]
FLAT_SPLIT_IDS = [f"{k}_shift{s}_{'bf16' if b else 'fp32'}_"
                  f"{'scale100' if c else 'scale1'}"
                  for k, s, b, c in FLAT_SPLIT_CASES]


@pytest.mark.parametrize("kind,shift,bf16,scale100", FLAT_SPLIT_CASES,
                         ids=FLAT_SPLIT_IDS)
def test_flat_split_products_match_pallas_interpret(kind, shift, bf16,
                                                    scale100):
    _flat_split_against_pallas(kind, shift, bf16, scale100, False)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["k2", "k5"])
def test_flat_split_products_mxu_bf16_match_pallas_interpret(kind, bf16):
    _flat_split_against_pallas(kind, 2, bf16, None, True)


def _underflowing_row_inputs(seed):
    """Inputs whose query row 3 has every logit 90-110 below the fixed shift
    m_h (scale 10, bias in [0, 1) but −90 on that row): exp(s − m) is
    subnormal or zero there and the row's sum falls under the 1e-30 clamp,
    so r = 1e30 and p = e·r stays a small normal number."""
    qkv, _, _, g = _flat_inputs(seed)
    H, N = 2, qkv.shape[1]
    bias = np.random.RandomState(seed + 1).rand(H, N, N).astype(np.float32)
    bias[:, 3, :] = -90.0
    return qkv, bias, np.full(H, 10.0, np.float32), g


@pytest.mark.parametrize("kind", ["k2", "k5"])
def test_flat_split_underflowing_row(kind):
    """The underflowing row against the Pallas K2 / K5 at the card's
    tolerances, finite everywhere."""
    qkv, bias, scale, g = _underflowing_row_inputs(45)
    tq, tb, ts, tg = _t(qkv, bias, scale, g)
    _, r = twa.window_attention_flat_plain(tq, tb, ts, return_rowsum=True)
    assert bool((r[:, :, 3] == 1e30).all()) and bool((r[:, :, 4] < 1e30).all())
    j = list(map(jnp.asarray, (qkv, bias, scale, g)))
    if kind == "k2":
        jo, jr = jwa.pallas_window_attention_flat(*j[:3], interpret=True,
                                                  return_rowsum=True)
        want = jwa.pallas_window_attention_flat_bwd2(*j[:3], jo, jr, j[3],
                                                     interpret=True)
        Bn, N = qkv.shape[:2]
        got = twa._flat_bwd_split(
            tq, tb, ts, tg, o=torch.as_tensor(np.array(jo)),
            r=torch.as_tensor(np.array(jr)).permute(1, 0, 2, 3).reshape(
                Bn, -1, N))
    else:
        want = jwa.pallas_window_attention_flat_bwd(*j, interpret=True)
        got = twa._flat_bwd_split(tq, tb, ts, tg)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    C = g.shape[-1]
    _assert_card_tolerances(
        [got[0][..., i * C:(i + 1) * C] for i in range(3)] + list(got[1:]),
        want, False)


# The forwards: K1 (one fixed-shift pass) and K7/K8 (a row pass, then the
# output pass) form s and p·v on the card as bf16 tensor-core products of
# split operands. ``_flat_fwd_split`` and ``_core_fwd_split`` are that
# arithmetic, held here against the Pallas forwards in interpret mode at the
# card's tolerances: fp32 outputs within 1e-4 of their largest value, bf16
# outputs within two bf16 ulps of it, K1's row sums within relative 1e-4;
# with ``mxu_bf16`` (both sides round the same operands to bf16, and a value
# on a rounding boundary may go either way) outputs within two bf16 ulps.

def _assert_fwd_close(got, want, rel):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _fwd_rel(bf16, mxu):
    return 2.0 ** -6 if bf16 or mxu else 1e-4


def _flat_forward_against_pallas(qkv, bias, scale, geom, bf16, mxu):
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jq = jnp.asarray(qkv, jdt)
    jo, jr = jwa.pallas_window_attention_flat(
        jq, jnp.asarray(bias), jnp.asarray(scale), interpret=True,
        return_rowsum=True, out_dtype=jdt, mxu_bf16=mxu, **geom)
    tq = torch.as_tensor(np.array(jq.astype(jnp.float32)))
    out, r = twa._flat_fwd_split(tq.bfloat16() if bf16 else tq,
                                 *_t(bias, scale), **geom, mxu_bf16=mxu)
    Bn, N = qkv.shape[:2]
    want_r = torch.as_tensor(np.array(jr)).permute(1, 0, 2, 3).reshape(
        Bn, -1, N)
    assert float(((r - want_r) / want_r).abs().max()) <= 1e-4
    _assert_fwd_close(out.bfloat16() if bf16 else out, jo,
                      _fwd_rel(bf16, mxu))
    return r


FWD_CASES = [(shift, bf16, scale, False) for shift in (0, 2)
                  for bf16 in (False, True) for scale in (None, 100.0)] + [
    (2, bf16, None, True) for bf16 in (False, True)]
FWD_IDS = [f"shift{s}_{'bf16' if b else 'fp32'}_"
                f"{'scale100' if c else 'scale1'}{'_mxu_bf16' if m else ''}"
                for s, b, c, m in FWD_CASES]


@pytest.mark.parametrize("shift,bf16,scale100,mxu", FWD_CASES,
                         ids=FWD_IDS)
def test_flat_forward_split_products_match_pallas_interpret(shift, bf16,
                                                            scale100, mxu):
    qkv, bias, scale, _ = _flat_inputs(46)
    if scale100:
        scale = np.full_like(scale, scale100)
    geom = dict(shift=shift, nWh=2, nWw=2) if shift else {}
    _flat_forward_against_pallas(qkv, bias, scale, geom, bf16, mxu)


def test_flat_forward_split_underflowing_row():
    """Query row 3's row sum falls under the 1e-30 clamp: r = 1e30 on both
    sides, and the output stays finite."""
    qkv, bias, scale, _ = _underflowing_row_inputs(47)
    r = _flat_forward_against_pallas(qkv, bias, scale, {}, False, False)
    assert bool((r[:, :, 3] == 1e30).all()) and bool((r[:, :, 4] < 1e30).all())


@pytest.mark.parametrize("shift,bf16,scale100,mxu", FWD_CASES,
                         ids=FWD_IDS)
def test_map_forward_split_products_match_pallas_interpret(shift, bf16,
                                                           scale100, mxu):
    """K7: the mask synthesised from the shift, fp32 output whatever qkv's
    dtype (v takes one term when qkv is bf16)."""
    qkv, bias, scale, _ = _map_inputs(48, hd=32)
    if scale100:
        scale = np.full_like(scale, scale100)
    jq = jnp.asarray(qkv, jnp.bfloat16 if bf16 else jnp.float32)
    want = jwa.pallas_window_attention_map(
        jq, jnp.asarray(bias), jnp.asarray(scale), shift, interpret=True,
        mxu_bf16=mxu)
    tq, tb, ts = _t(np.array(jq.astype(jnp.float32)), bias, scale)
    out = twa._core_fwd_split(*twa._map_to_windows(tq, 4), tb, ts,
                              twa._map_mask(tq, 4, shift, 8, 8), bf16, mxu,
                              mxu)
    _assert_fwd_close(twa._windows_to_map(out, 2, 8, 8, 4), want,
                      2.0 ** -6 if mxu else 1e-4)


@pytest.mark.parametrize("masked,bf16,scale100", SPLIT_CASES, ids=SPLIT_IDS)
def test_head_forward_split_products_match_pallas_interpret(masked, bf16,
                                                            scale100):
    """K8: the mask operand, output in q's dtype, p rounded to v's dtype
    before p·v."""
    q, k, v, bias, scale, _ = _head_inputs(49, hd=32)
    if scale100:
        scale = np.full_like(scale, scale100)
    mask = _shift_mask() if masked else None
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = jwa.pallas_window_attention(jq, jk, jv, jnp.asarray(bias),
                                       jnp.asarray(scale), mask,
                                       interpret=True)
    tq, tk, tv = _t(*(np.array(a.astype(jnp.float32)) for a in (jq, jk, jv)))
    out = twa._core_fwd_split(tq, tk, tv, *_t(bias, scale),
                              twa._mask_tensor(mask, tq.device), bf16, False,
                              bf16)
    _assert_fwd_close(out.bfloat16() if bf16 else out, want,
                      _fwd_rel(bf16, False))


def test_split_terms_rebuild_the_operand():
    """Two terms leave 2⁻¹⁶ of the value, three are exact in fp32."""
    x = torch.as_tensor(np.random.RandomState(43).randn(64, 32).astype(
        np.float32))
    two, three = twa._split16(x, 2), twa._split16(x, 3)
    assert all(torch.equal(t, t.bfloat16().float()) for t in three)
    assert float((sum(two) - x).abs().max()) <= 2.0 ** -16 * float(x.abs().max())
    assert torch.equal(three[0] + three[1] + three[2], x)


@pytest.mark.parametrize("bad", [
    dict(q=(6, 2, 16, 8)),                       # Bn % nW
    dict(k=(4, 2, 16, 4)),                       # k unlike q
    dict(bias=(2, 16, 15)),
    dict(scale=3),
    dict(mask=(4, 16, 15)),
], ids=["windows", "kshape", "bias", "scales", "maskshape"])
def test_head_layout_errors_raise(bad):
    q = torch.zeros(bad.get("q", (4, 2, 16, 8)))
    k = torch.zeros(bad.get("k", tuple(q.shape)))
    bias = torch.zeros(bad.get("bias", (2, 16, 16)))
    scale = torch.ones(bad.get("scale", 2))
    mask = torch.zeros(bad.get("mask", (4, 16, 16)))
    for fn in (twa.window_attention, twa.window_attention_fwd,
               twa.window_attention_plain):
        with pytest.raises(ValueError):
            fn(q, k, q, bias, scale, mask)
    with pytest.raises(ValueError):
        twa.window_attention_bwd(q, k, q, bias, scale, q, mask)


def test_head_layout_error_names_shapes():
    q = torch.zeros(6, 2, 16, 8)
    with pytest.raises(ValueError, match=r"Bn=6.*nW=4"):
        twa.window_attention(q, q, q, torch.zeros(2, 16, 16), torch.ones(2),
                             torch.zeros(4, 16, 16))


@pytest.mark.parametrize("bad", [
    dict(qkv=(2, 8, 6, 3, 2, 8)),                # Wp % ws
    dict(qkv=(2, 8, 8, 2, 2, 8)),                # not 3 parts
    dict(bias=(2, 15, 15)),                      # N not a square
    dict(scale=3),
    dict(g=(2, 8, 8, 2, 4)),
], ids=["windows", "three", "bias", "scales", "gshape"])
def test_map_layout_errors_raise(bad):
    qkv = torch.zeros(bad.get("qkv", (2, 8, 8, 3, 2, 8)))
    bias = torch.zeros(bad.get("bias", (2, 16, 16)))
    scale = torch.ones(bad.get("scale", 2))
    g = torch.zeros(bad.get("g", (2, 8, 8, 2, 8)))
    if "g" not in bad:
        for fn in (twa.window_attention_map, twa.window_attention_map_fwd,
                   twa.window_attention_map_plain):
            with pytest.raises(ValueError):
                fn(qkv, bias, scale, 2)
    with pytest.raises(ValueError):
        twa.window_attention_map_bwd(qkv, bias, scale, g, 2)
