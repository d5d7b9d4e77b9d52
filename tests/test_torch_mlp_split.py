"""The card kernels' arithmetic for K3/K3b/K4/K4b against the JAX package.

``csrc/mlp_ln.cu`` forms every product on the tensor cores from bf16
operands: a bf16 operand as it is, an fp32 one as two bf16 terms (hi·hi +
hi·lo + lo·hi, fp32 sums), with h, dz·mask/keep and dh_pre rounded to x's
type (fp32: split into terms) before their products.
``fused_dense._mlp_ln_split`` is that arithmetic in plain PyTorch; here it
is held against the Pallas ``mlp_ln`` / ``mlp_ln_res`` in interpret mode,
forward and backward (``jax.vjp``), on the same numpy inputs, with and
without the residual and the keep-mask, at a row count the tiles divide,
one they pad and a 3-d input, at the tolerances the kernels are held to on
the card (PERF.md §2): fp32 y within 1e-4 of its largest value and each
fp32 gradient within relative L2 1e-4 (two-term products leave about 2⁻¹⁷
of each product; the Pallas GELU takes a polynomial erf within 1.5e-7);
bf16 y within two bf16 ulps of its largest value (both round one fp32
value, summed in another order) and the bf16 gradients within relative L2
1e-2 (dz and dh_pre are rounded to bf16 before their products, and a value
near a rounding boundary may round either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu.ops import fused_dense as jfd
from mvuld_tpu_torch.ops import fused_dense as fd
from jax_reference import no_persistent_compile_cache  # noqa: F401

KEEP = 0.9
NAMES = ("dx", "dW1", "db1", "dW2", "db2", "dgamma", "dbeta")


def _inputs(lead, C, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (sc * rng.randn(*s)).astype(np.float32)  # noqa: E731
    Hd = 4 * C
    params = (f(*lead, C), f(C, Hd, sc=C ** -0.5), f(Hd, sc=0.1),
              f(Hd, C, sc=Hd ** -0.5), f(C, sc=0.1), 1.0 + f(C, sc=0.1),
              f(C, sc=0.1))
    mask = (rng.rand(*lead, C) < KEEP).astype(np.float32)
    return params, mask, f(*lead, C)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


VARIANTS = {"mlp_ln": (False, False), "res": (True, False),
            "res_mask": (True, True)}
LEADS = [((48,), 64), ((37,), 32), ((3, 19), 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,C", LEADS, ids=["aligned", "unaligned", "3d"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mlp_split_products_match_pallas_interpret(variant, lead, C, dtype):
    residual, masked = VARIANTS[variant]
    keep = KEEP if masked else 1.0
    eps = 1e-5 if residual else 1e-6
    args, mask, dy = _inputs(lead, C, seed=11 + len(lead) + C)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jmask = jnp.asarray(mask, jdt)
    if residual:
        jfn = lambda *a: jfd.mlp_ln_res(*a, jmask, keep, True)  # noqa: E731
    else:
        jfn = lambda *a: jfd.mlp_ln(*a, True)  # noqa: E731
    jargs = [jnp.asarray(args[0], jdt)] + [jnp.asarray(a) for a in args[1:]]
    jy, vjp = jax.vjp(jfn, *jargs)
    want = vjp(jnp.asarray(dy, jdt))

    targs = [torch.tensor(args[0]).to(tdt)] + [torch.tensor(a)
                                                for a in args[1:]]
    y, got = fd._mlp_ln_split(
        *targs, residual=residual, eps=eps,
        mask=torch.tensor(mask).to(tdt) if masked else None, keep_prob=keep,
        dy=torch.tensor(dy).to(tdt))
    assert y.dtype == tdt and y.shape == lead + (C,)
    assert got[0].dtype == tdt and got[0].shape == lead + (C,)
    jy = np.asarray(jy, np.float32)
    rel = 1e-4 if dtype == "float32" else 2.0 ** -6
    assert np.abs(y.float().numpy() - jy).max() <= rel * np.abs(jy).max()
    lim = 1e-4 if dtype == "float32" else 1e-2
    for a, b, name in zip(got, want, NAMES):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        assert _rel_l2(a.float().numpy(), b) <= lim, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_arithmetic_stays_with_the_plain_version(dtype):
    """The plain versions (which the kernels are held to on the card) and
    the kernels' split arithmetic agree: fp32 within 1e-5 (the terms' 2⁻¹⁷),
    bf16 to two ulps of y and 1e-2 relative L2 of each gradient."""
    args, mask, dy = _inputs((40,), 32, seed=5)
    t = [torch.tensor(args[0]).to(dtype)] + [torch.tensor(a) for a in args[1:]]
    m, g = torch.tensor(mask).to(dtype), torch.tensor(dy).to(dtype)
    kw = dict(residual=True, eps=1e-5, mask=m, keep_prob=KEEP)
    y, got = fd._mlp_ln_split(*t, dy=g, **kw)
    y_p = fd.mlp_ln_plain(*t, **kw)
    want = fd.mlp_ln_bwd_plain(t[0], g, *t[1:6], **kw)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    assert float((y.float() - y_p.float()).abs().max()) <= \
        rel * float(y_p.float().abs().max())
    lim = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b, name in zip(got, want, NAMES):
        assert _rel_l2(a.float().numpy(), b.float().numpy()) <= lim, name


def test_two_terms_rebuild_the_operand():
    """hi + lo leaves at most 2⁻¹⁶ of the value; one term is bf16 itself."""
    x = torch.as_tensor(np.random.RandomState(9).randn(64, 48).astype(
        np.float32))
    hi, lo = fd._terms(x, 2)
    assert torch.equal(hi, x.bfloat16().float())
    assert torch.equal(lo, (x - hi).bfloat16().float())
    assert float((hi + lo - x).abs().max()) <= 2.0 ** -16 * float(
        x.abs().max())
    assert fd._terms(x.bfloat16().float(), 1)[0].equal(x.bfloat16().float())
