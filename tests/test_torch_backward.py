"""The port's plain K2, K3b and K4b against the JAX package, on the CPU.

- K1's row sums and K2 (``window_attention_flat_bwd_plain``) against the
  Pallas kernels ``pallas_window_attention_flat(return_rowsum=True)`` and
  ``pallas_window_attention_flat_bwd2`` in interpret mode, and the port's
  autograd function ``flat_attention`` against ``jax.vjp`` of the JAX
  ``window_attention_flat`` (its default v2 backward), at shift 0 and at
  shift 2 on a 2×2 window grid. fp32; both sides compute the same
  formulas in another summation order, so 1e-5 absolute on values of
  order one.
- K5 (``window_attention_flat_bwd_v1_plain``, the v1 backward) against
  ``pallas_window_attention_flat_bwd`` in interpret mode, and
  ``flat_attention(bwd_v2=False)`` against ``jax.vjp`` of
  ``window_attention_flat(bwd_v2=False)``, on the same geometries and at
  the same 1e-5; and the port's two generations against each other.
- ``mxu_bf16`` / ``MVULD_ATTN_MXU_BF16=1``: K1, K2 and K5 round their
  product operands as the Pallas kernels do, against the kernels with
  ``mxu_bf16=True`` in interpret mode (fp32 and bf16, shift 0 and 2), and
  ``flat_attention`` under the switch against ``jax.vjp`` of the JAX
  ``window_attention_flat`` under it (tolerances stated at the tests).
- K3b / K4b (the ``mlp_ln`` / ``mlp_ln_res`` autograd functions, whose
  backward on the CPU is ``mlp_ln_bwd_plain``) against ``jax.vjp`` of the
  Pallas ``mlp_ln`` / ``mlp_ln_res`` in interpret mode, K4b with the same
  {0,1} keep-mask at keep 0.9, for all seven gradients. The Pallas GELU
  differentiates a polynomial erf (|err| ≤ 1.5e-7) where the port takes
  the exact derivative; with the fp32 sums that stays within 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu.ops import fused_dense as jfd
from mvuld_tpu.ops import window_attention as jwa
from mvuld_tpu_torch.ops import fused_dense as fd
from mvuld_tpu_torch.ops import window_attention as wa
from jax_reference import no_persistent_compile_cache  # noqa: F401

ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
MLP_TOL = dict(atol=2e-5, rtol=2e-5)
GEOMS = [dict(), dict(shift=2, nWh=2, nWw=2)]
GEOM_IDS = ["shift0", "shift2_grid2x2"]


def _attn_inputs(seed, Bn=8, ws=4, heads=2, hd=8):
    rng = np.random.RandomState(seed)
    N, C = ws * ws, heads * hd
    return (rng.randn(Bn, N, 3 * C).astype(np.float32),
            rng.randn(heads, N, N).astype(np.float32),
            np.exp(rng.rand(heads)).astype(np.float32),
            rng.randn(Bn, N, C).astype(np.float32))


def _jax_rowsum(r, Bn, H, N):
    """[NB, Bn, GL, N] (the Pallas lane layout) → the port's [Bn, H, N]."""
    r = np.asarray(r)
    return r.transpose(1, 0, 2, 3).reshape(Bn, H, N)


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_rowsum_and_plain_k2_match_pallas_interpret(geom):
    qkv, bias, scale, g = _attn_inputs(seed=11)
    Bn, N = qkv.shape[:2]
    H = bias.shape[0]
    jo, jr = jwa.pallas_window_attention_flat(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(scale),
        interpret=True, return_rowsum=True, **geom)
    t = [torch.as_tensor(a) for a in (qkv, bias, scale, g)]
    out, r = wa.window_attention_flat(t[0], t[1], t[2], **geom,
                                      return_rowsum=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), **ATTN_TOL)
    np.testing.assert_allclose(r.numpy(), _jax_rowsum(jr, Bn, H, N),
                               rtol=1e-5)
    want = jwa.pallas_window_attention_flat_bwd2(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(scale), jo, jr,
        jnp.asarray(g), interpret=True, **geom)
    dqkv, dbias, dscale = wa.window_attention_flat_bwd(
        t[0], t[1], t[2], out, r, t[3], **geom)
    C = qkv.shape[-1] // 3
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose(dqkv[..., i * C:(i + 1) * C].numpy(),
                                   np.asarray(want[i]), **ATTN_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want[3]),
                               **ATTN_TOL)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(want[4]),
                               **ATTN_TOL)


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_flat_attention_grads_match_jax_vjp(geom):
    qkv, bias, scale, g = _attn_inputs(seed=12)
    fn = lambda q, b, s: jwa.window_attention_flat(  # noqa: E731
        q, b, s, interpret=True, bwd_v2=True, **geom)
    jout, vjp = jax.vjp(fn, jnp.asarray(qkv), jnp.asarray(bias),
                        jnp.asarray(scale))
    want = vjp(jnp.asarray(g))
    t = [torch.tensor(a, requires_grad=True) for a in (qkv, bias, scale)]
    out, _r = wa.flat_attention(*t, geom.get("shift", 0), geom.get("nWh", 1),
                                geom.get("nWw", 1))
    got = torch.autograd.grad(out, t, torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **ATTN_TOL)
    for a, b, name in zip(got, want, ("dqkv", "dbias", "dscale")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ATTN_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_plain_k5_matches_pallas_interpret(geom):
    qkv, bias, scale, g = _attn_inputs(seed=13)
    want = jwa.pallas_window_attention_flat_bwd(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(scale),
        jnp.asarray(g), interpret=True, **geom)
    t = [torch.as_tensor(a) for a in (qkv, bias, scale, g)]
    dqkv, dbias, dscale = wa.window_attention_flat_bwd_v1(*t, **geom)
    C = qkv.shape[-1] // 3
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose(dqkv[..., i * C:(i + 1) * C].numpy(),
                                   np.asarray(want[i]), **ATTN_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want[3]),
                               **ATTN_TOL)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(want[4]),
                               **ATTN_TOL)


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_flat_attention_v1_grads_match_jax_vjp_and_v2(geom):
    qkv, bias, scale, g = _attn_inputs(seed=14)
    fn = lambda q, b, s: jwa.window_attention_flat(  # noqa: E731
        q, b, s, interpret=True, bwd_v2=False, **geom)
    jout, vjp = jax.vjp(fn, jnp.asarray(qkv), jnp.asarray(bias),
                        jnp.asarray(scale))
    want = vjp(jnp.asarray(g))
    geo = (geom.get("shift", 0), geom.get("nWh", 1), geom.get("nWw", 1))
    grads = {}
    for v2 in (False, True):
        t = [torch.tensor(a, requires_grad=True) for a in (qkv, bias, scale)]
        out, r = wa.flat_attention(*t, *geo, bwd_v2=v2)
        assert (r is None) == (not v2)
        grads[v2] = torch.autograd.grad(out, t, torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **ATTN_TOL)
    for a, b, c, name in zip(grads[False], want, grads[True],
                             ("dqkv", "dbias", "dscale")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ATTN_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), c.numpy(), **ATTN_TOL,
                                   err_msg=name)


def test_flat_attention_follows_mvuld_attn_bwd(monkeypatch):
    """``MVULD_ATTN_BWD=v1`` selects K5, as it selects the v1 backward in
    the JAX package; unset, v2."""
    qkv, bias, scale, _ = _attn_inputs(seed=15)
    t = [torch.as_tensor(a) for a in (qkv, bias, scale)]
    monkeypatch.setenv("MVULD_ATTN_BWD", "v1")
    assert wa.flat_attention(*t)[1] is None
    monkeypatch.delenv("MVULD_ATTN_BWD")
    assert wa.flat_attention(*t)[1] is not None


# mxu_bf16 (MVULD_ATTN_MXU_BF16=1): the port's flat attention rounds the
# product operands as the JAX package's does — K1 q̂, k̂, e and v; K2 q̂, k̂,
# g, v, ds and p; K5 q̂, k̂, g, v, ds, e and r·g. Both sides round the same
# fp32 values, so a value on a rounding boundary may go either way: fp32
# outputs within one bf16 ulp of the largest value (2⁻⁸ relative), and
# outputs rounded to bf16 (and the K5 gradients, which the Pallas kernel
# writes in fp32 where the port writes qkv's bf16) within two (2⁻⁷).
MXU_DTYPES = [(np.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _close_to_largest(got, want, rel, name):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, name
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), name


def _mxu_inputs(seed, jdt, tdt):
    qkv, bias, scale, g = _attn_inputs(seed)
    jq, jg = jnp.asarray(qkv, jdt), jnp.asarray(g, jdt)
    tq, tg = (torch.as_tensor(np.array(a.astype(jnp.float32))).to(tdt)
              for a in (jq, jg))
    return (jq, jnp.asarray(bias), jnp.asarray(scale), jg), \
        (tq, torch.as_tensor(bias), torch.as_tensor(scale), tg)


@pytest.mark.parametrize("dtypes", MXU_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_mxu_bf16_k1_and_k2_match_pallas_interpret(geom, dtypes):
    """K1 and K2 with ``mxu_bf16`` against the Pallas forward (output in
    qkv's dtype, as the JAX v2 path writes it) and ``_flat_bwd2``, K2 fed
    the Pallas forward's output and row sums."""
    (jq, jb, js, jg), (tq, tb, ts, tg) = _mxu_inputs(16, *dtypes)
    Bn, N, C3 = tq.shape
    C, H = C3 // 3, tb.shape[0]
    jo, jr = jwa.pallas_window_attention_flat(
        jq, jb, js, interpret=True, return_rowsum=True, out_dtype=jq.dtype,
        mxu_bf16=True, **geom)
    out, r = wa.window_attention_flat(tq, tb, ts, **geom, return_rowsum=True,
                                      mxu_bf16=True)
    bf16 = tq.dtype == torch.bfloat16
    assert out.dtype == tq.dtype
    _close_to_largest(out, jo, 2.0 ** (-7 if bf16 else -8), "out")
    np.testing.assert_allclose(r.numpy(), _jax_rowsum(jr, Bn, H, N),
                               rtol=1e-5)
    want = jwa.pallas_window_attention_flat_bwd2(
        jq, jb, js, jo, jr, jg, interpret=True, mxu_bf16=True, **geom)
    to = torch.as_tensor(np.array(jo.astype(jnp.float32))).to(tq.dtype)
    dqkv, dbias, dscale = wa.window_attention_flat_bwd(
        tq, tb, ts, to, torch.tensor(_jax_rowsum(jr, Bn, H, N)), tg,
        **geom, mxu_bf16=True)
    assert dqkv.dtype == tq.dtype
    rel = 2.0 ** (-7 if bf16 else -8)
    for i, name in enumerate(("dq", "dk", "dv")):
        _close_to_largest(dqkv[..., i * C:(i + 1) * C], want[i], rel, name)
    _close_to_largest(dbias, want[3], 2.0 ** -8, "dbias")
    _close_to_largest(dscale, want[4], 2.0 ** -8, "dscale")


@pytest.mark.parametrize("dtypes", MXU_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_mxu_bf16_k5_matches_pallas_interpret(geom, dtypes):
    (jq, jb, js, jg), (tq, tb, ts, tg) = _mxu_inputs(17, *dtypes)
    C = tq.shape[-1] // 3
    want = jwa.pallas_window_attention_flat_bwd(
        jq, jb, js, jg, interpret=True, mxu_bf16=True, **geom)
    dqkv, dbias, dscale = wa.window_attention_flat_bwd_v1(
        tq, tb, ts, tg, **geom, mxu_bf16=True)
    assert dqkv.dtype == tq.dtype
    for i, name in enumerate(("dq", "dk", "dv")):
        _close_to_largest(dqkv[..., i * C:(i + 1) * C], want[i], 2.0 ** -7,
                          name)
    _close_to_largest(dbias, want[3], 2.0 ** -8, "dbias")
    _close_to_largest(dscale, want[4], 2.0 ** -8, "dscale")


@pytest.mark.parametrize("v2", [True, False], ids=["v2_k2", "v1_k5"])
@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_flat_attention_follows_mxu_bf16_switch_as_jax(monkeypatch, geom, v2):
    """With ``MVULD_ATTN_MXU_BF16=1`` the port's ``flat_attention`` (K1 and
    K2 or K5) and ``jax.vjp`` of the JAX ``window_attention_flat`` both
    round their product operands: forward and gradients agree within one
    bf16 ulp of the largest value; without the switch they do not round."""
    monkeypatch.setenv("MVULD_ATTN_MXU_BF16", "1")
    qkv, bias, scale, g = _attn_inputs(seed=18)
    fn = lambda q, b, s: jwa.window_attention_flat(  # noqa: E731
        q, b, s, interpret=True, bwd_v2=v2, **geom)
    jout, vjp = jax.vjp(fn, jnp.asarray(qkv), jnp.asarray(bias),
                        jnp.asarray(scale))
    want = vjp(jnp.asarray(g))
    geo = (geom.get("shift", 0), geom.get("nWh", 1), geom.get("nWw", 1))
    t = [torch.tensor(a, requires_grad=True) for a in (qkv, bias, scale)]
    out, _ = wa.flat_attention(*t, *geo, bwd_v2=v2)
    got = torch.autograd.grad(out, t, torch.as_tensor(g))
    _close_to_largest(out.detach(), jout, 2.0 ** -8, "out")
    for a, b, name in zip(got, want, ("dqkv", "dbias", "dscale")):
        _close_to_largest(a, b, 2.0 ** -8, name)
    monkeypatch.delenv("MVULD_ATTN_MXU_BF16")
    exact = wa.flat_attention(*[x.detach() for x in t], *geo, bwd_v2=v2)[0]
    assert not torch.equal(exact, out.detach())


def test_flat_attention_mxu_bf16_env_default(monkeypatch):
    """``MVULD_ATTN_MXU_BF16=1`` is ``mxu_bf16=True`` for the forward and
    both backward generations; unset, ``flat_attention`` does not round."""
    qkv, bias, scale, g = _attn_inputs(seed=19)

    def run(v2, **kw):
        t = [torch.tensor(a, requires_grad=True) for a in (qkv, bias, scale)]
        out, _ = wa.flat_attention(*t, 2, 2, 2, bwd_v2=v2, **kw)
        return (out,) + torch.autograd.grad(out, t, torch.as_tensor(g))

    for v2 in (True, False):
        plain = run(v2)
        monkeypatch.setenv("MVULD_ATTN_MXU_BF16", "1")
        rounded = run(v2)
        monkeypatch.delenv("MVULD_ATTN_MXU_BF16")
        assert all(torch.equal(a, b)
                   for a, b in zip(rounded, run(v2, mxu_bf16=True)))
        assert not any(torch.equal(a, b) for a, b in zip(rounded, plain))


def _mlp_inputs(lead, C=32, Hd=128, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (sc * rng.randn(*s)).astype(np.float32)  # noqa: E731
    return (f(*lead, C), f(C, Hd, sc=0.2), f(Hd, sc=0.1), f(Hd, C, sc=0.1),
            f(C, sc=0.1), 1.0 + f(C, sc=0.1), f(C, sc=0.1)), f(*lead, C)


GRADS = ("dx", "dw1", "db1", "dw2", "db2", "dgamma", "dbeta")


@pytest.mark.parametrize("lead", [(48,), (3, 19)], ids=["aligned", "3d"])
@pytest.mark.parametrize("residual", [False, True],
                         ids=["k3b_mlp_ln", "k4b_mlp_ln_res_keep0.9"])
def test_mlp_ln_grads_match_jax_vjp(lead, residual):
    args, dy = _mlp_inputs(lead, seed=21 + residual)
    mask = (np.random.RandomState(5).rand(*args[0].shape) < 0.9
            ).astype(np.float32)
    if residual:
        jfn = lambda *a: jfd.mlp_ln_res(*a, jnp.asarray(mask), 0.9, True)  # noqa: E731
        pfn = lambda *a: fd.mlp_ln_res(*a, torch.as_tensor(mask), 0.9)  # noqa: E731
    else:
        jfn = lambda *a: jfd.mlp_ln(*a, True)  # noqa: E731
        pfn = fd.mlp_ln
    jy, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    t = [torch.tensor(a, requires_grad=True) for a in args]
    y = pfn(*t)
    got = torch.autograd.grad(y, t, torch.as_tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **MLP_TOL)
    for a, b, name in zip(got, want, GRADS):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MLP_TOL,
                                   err_msg=name)


def test_mlp_ln_res_unread_mask_at_keep_one():
    """keep_prob 1: the mask is not read (the JAX kernel's contract)."""
    args, _ = _mlp_inputs((16,), seed=3)
    t = [torch.as_tensor(a) for a in args]
    junk = torch.full_like(t[0], 7.0)
    torch.testing.assert_close(fd.mlp_ln_res(*t, junk, 1.0),
                               fd.mlp_ln_res(*t))


def test_backward_wrappers_never_fall_back_off_the_cpu():
    """K2, K5, K3b/K4b and K6b on a non-CPU tensor launch or raise (meta
    tensors stand in for a device here)."""
    m = torch.device("meta")
    z = lambda *s: torch.zeros(*s, device=m)  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        wa.window_attention_flat_bwd(z(4, 16, 96), z(1, 16, 16), z(1),
                                     z(4, 16, 32), z(4, 1, 16),
                                     z(4, 16, 32))
    w = [z(16, 128), z(128), z(128, 16), z(16), z(16)]
    for fn in (fd.mlp_ln_bwd, fd.mlp_ln_res_bwd):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(z(8, 16), z(8, 16), *w)
    with pytest.raises(ValueError, match="unsupported device"):
        wa.window_attention_flat_bwd_v1(z(4, 16, 96), z(1, 16, 16), z(1),
                                        z(4, 16, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        fd.dense_bwd(z(8, 16), z(16, 32), z(32), z(32), z(8, 32))
    assert wa.window_attention_flat_bwd.launches == 0
    assert wa.window_attention_flat_bwd_v1.launches == 0
    assert fd.mlp_ln_bwd.launches == 0 and fd.mlp_ln_res_bwd.launches == 0
    assert fd.dense_bwd.launches == 0
