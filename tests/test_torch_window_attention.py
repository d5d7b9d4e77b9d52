"""The port's plain K1 (``window_attention_flat_plain``) against the JAX
Pallas kernel ``pallas_window_attention_flat`` in interpret mode.

Both compute the kernel numerics (rsqrt normalisation, fixed per-head
softmax shift, row sums clamped at 1e-30, the shift mask from the window
id), so they agree to 1e-5 in fp32. On the CPU the wrapper
``window_attention_flat`` is the plain version; the CUDA kernel is held
against it on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu.ops.window_attention import pallas_window_attention_flat
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
