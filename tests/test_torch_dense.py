"""The port's K6 / K6b (``dense_act`` / ``dense_ln`` and their autograd
function, plain versions on the CPU) against the JAX package's Pallas
kernels in interpret mode, and the port's block microbenchmark.

- Forward values and every gradient (dx, dW, db, and dγ, dβ under LN) of
  ``dense_act`` and ``dense_ln``, act gelu or none, at a row count the
  Pallas tile divides (48) and one it pads (50), in fp32 and bf16, against
  ``jax.vjp`` of the JAX ``dense_act`` / ``dense_ln(interpret=True)`` on
  the same numpy inputs and output gradient. fp32: 2e-5 relative and
  absolute (the same fp32 formulas in another summation order; the Pallas
  GELU differentiates a polynomial erf within 1.5e-7 of the exact one).
  bf16: y within two bf16 ulps of its largest value and each gradient
  within relative L2 1e-2 (both round z's epilogue and dz to bf16 once,
  from fp32 sums taken in another order, so a value near a rounding
  boundary may round either way).
- The five variants of ``tools/blockbench.py`` build the same block: at
  M = 64 their forward outputs x + y agree within two bf16 ulps of the
  largest output (the residual sum rounds to bf16) and their x-gradients
  within relative L2 5e-2 (v0-v2 take jax.nn.gelu's tanh form, as the
  JAX benchmark does, and bf16 products; v3/v4 the exact erf with fp32
  sums); the CLI prints one JSON line per variant and mode.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu.ops import fused_dense as jfd
from mvuld_tpu_torch.ops import fused_dense as fd
from jax_reference import no_persistent_compile_cache  # noqa: F401


def _inputs(M, K=32, N=64, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (sc * rng.randn(*s)).astype(np.float32)  # noqa: E731
    return (f(M, K), f(K, N, sc=0.1), f(N, sc=0.1), 1.0 + f(N, sc=0.1),
            f(N, sc=0.1)), f(M, N)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [48, 50], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("act", ["gelu", "none"])
@pytest.mark.parametrize("ln", [False, True], ids=["dense_act", "dense_ln"])
def test_dense_matches_pallas_interpret(ln, act, M, dtype):
    (x, w, b, gamma, beta), dy = _inputs(M, seed=3 + 2 * ln + (act == "gelu"))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    n = 5 if ln else 3
    if ln:
        jfn = lambda x, w, b, g, bt: jfd.dense_ln(  # noqa: E731
            x, w, b, g, bt, act=act, interpret=True)
        pfn = lambda x, w, b, g, bt: fd.dense_ln(x, w, b, g, bt, act)  # noqa: E731
    else:
        jfn = lambda x, w, b: jfd.dense_act(  # noqa: E731
            x, w, b, act=act, interpret=True)
        pfn = lambda x, w, b: fd.dense_act(x, w, b, act)  # noqa: E731
    args = (x, w, b, gamma, beta)[:n]
    jargs = [jnp.asarray(args[0], jdt)] + [jnp.asarray(a) for a in args[1:]]
    jy, vjp = jax.vjp(jfn, *jargs)
    want = vjp(jnp.asarray(dy, jdt))
    t = [torch.tensor(args[0]).to(tdt).requires_grad_()] + \
        [torch.tensor(a, requires_grad=True) for a in args[1:]]
    y = pfn(*t)
    got = torch.autograd.grad(y, t, torch.tensor(dy).to(tdt))
    assert y.dtype == tdt and y.shape == (M, w.shape[1])
    jy = np.asarray(jy, np.float32)
    names = ("dx", "dw", "db", "dgamma", "dbeta")
    if dtype == "float32":
        np.testing.assert_allclose(y.detach().numpy(), jy, rtol=2e-5,
                                   atol=2e-5)
        for a, b_, name in zip(got, want, names):
            assert a.dtype == torch.float32, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=2e-5,
                                       atol=2e-5, err_msg=name)
    else:
        tol = 2.0 ** -6 * float(np.abs(jy).max())
        assert float(np.abs(y.detach().float().numpy() - jy).max()) <= tol
        for a, b_, name in zip(got, want, names):
            assert a.shape == b_.shape, name
            assert _rel_l2(a.float().numpy(), b_) <= 1e-2, name


def test_dense_bwd_plain_ignores_padded_rows():
    """K6b's column sums over M rows equal those over the same rows with
    zero rows appended (the JAX kernel pads M to its tile with zeros)."""
    (x, w, b, gamma, _), dy = _inputs(50, seed=9)
    t = [torch.as_tensor(a) for a in (x, w, b, gamma, dy)]
    dz, vecs = fd.dense_bwd(t[0], t[1], t[2], t[3], t[4], "gelu", True)
    pad = lambda a: torch.cat([a, torch.zeros(14, a.shape[1])])  # noqa: E731
    dz_p, vecs_p = fd.dense_bwd(pad(t[0]), t[1], t[2], t[3], pad(t[4]),
                                "gelu", True)
    torch.testing.assert_close(dz_p[:50], dz)
    torch.testing.assert_close(vecs_p, vecs, atol=1e-6, rtol=1e-6)


def test_blockbench_variants_agree():
    from mvuld_tpu_torch.tools.blockbench import build_mlp_ln
    outs, gx = {}, {}
    for v in ("v0", "v1", "v2", "v3", "v4"):
        mlp, _, _, params, x0, _ = build_mlp_ln(v, 64, C=32, Hd=128,
                                                device="cpu")
        x = x0.clone().requires_grad_()
        y = mlp(params, x)
        outs[v] = y.detach().float()
        gx[v] = torch.autograd.grad(y.float().sum(), x)[0].float()
    for v in ("v0", "v1", "v2", "v3"):
        tol = 2.0 ** -6 * float(outs["v4"].abs().max())
        assert float((outs[v] - outs["v4"]).abs().max()) <= tol, v
        assert _rel_l2(gx[v].numpy(), gx["v4"].numpy()) <= 5e-2, v


def test_blockbench_cli_prints_a_line_per_variant_and_mode(capsys):
    from mvuld_tpu_torch.tools.blockbench import main
    main(["--variant", "v0,v3", "--batch", "1", "--tokens", "32",
          "--dim", "32", "--iters", "2", "--mode", "both", "--remat",
          "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [(r["variant"], r["mode"]) for r in lines] == [
        ("v0", "fwd"), ("v0", "fwd_bwd"), ("v3", "fwd"), ("v3", "fwd_bwd")]
    for r in lines:
        assert r["M"] == 32 and r["ms_per_iter"] > 0
        assert r["device"] == "cpu" and r["share_of_bf16_peak"] is None
