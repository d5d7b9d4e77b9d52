"""The port's plain K3/K4 (``mlp_ln_plain``) against the JAX Pallas
``mlp_ln`` / ``mlp_ln_res`` in interpret mode, fp32, tolerance 1e-5.

The Pallas kernels take GELU through a polynomial erf (|err| ≤ 1.5e-7); the
port uses the exact erf, well inside the tolerance. On the CPU the wrappers
``mlp_ln``/``mlp_ln_res`` are the plain version; the CUDA kernel is held
against it on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu.ops import fused_dense as jfd
from mvuld_tpu_torch.ops.fused_dense import mlp_ln, mlp_ln_plain, mlp_ln_res
from jax_reference import no_persistent_compile_cache  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _setup(lead, C=32, Hd=128, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (sc * rng.randn(*s)).astype(np.float32)  # noqa: E731
    return (f(*lead, C), f(C, Hd, sc=0.2), f(Hd, sc=0.1), f(Hd, C, sc=0.1),
            f(C, sc=0.1), 1.0 + f(C, sc=0.1), f(C, sc=0.1))


@pytest.mark.parametrize("lead", [(48,), (37,), (3, 19)],
                         ids=["aligned", "unaligned", "3d"])
def test_mlp_ln_matches_pallas_interpret(lead):
    args = _setup(lead, seed=1)
    want = np.asarray(jfd.mlp_ln(*map(jnp.asarray, args), True))
    got = mlp_ln(*map(torch.as_tensor, args)).numpy()
    assert got.shape == lead + (32,)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("lead", [(48,), (37,), (3, 19)],
                         ids=["aligned", "unaligned", "3d"])
def test_mlp_ln_res_matches_pallas_interpret(lead):
    """JAX with keep_prob 1 (its mask operand unread); the port's inference
    form has no mask operand."""
    args = _setup(lead, seed=2)
    mask = np.zeros(args[0].shape, np.float32)
    want = np.asarray(jfd.mlp_ln_res(*map(jnp.asarray, args),
                                     jnp.asarray(mask), 1.0, True))
    got = mlp_ln_res(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("which", [2, 3, 4, 5, 6], ids=["b1", "w2", "b2",
                                                       "gamma", "beta"])
def test_mismatched_vector_shapes_raise(which):
    """A bias or LayerNorm vector that does not fit w1 is refused before
    any kernel could read past it."""
    args = [torch.as_tensor(a) for a in _setup((8,), seed=5)]
    args[which] = args[which][..., :-1]
    for fn in (mlp_ln, mlp_ln_res):
        with pytest.raises(ValueError, match="do not fit"):
            fn(*args)


def test_plain_bf16_rounds_hidden_like_the_kernel():
    """In bf16 the hidden activation is rounded before the second product,
    as the Pallas kernel does; the output keeps x's dtype."""
    args = [torch.as_tensor(a) for a in _setup((16,), seed=4)]
    args[0] = args[0].bfloat16()
    out = mlp_ln_plain(*args)
    assert out.dtype == torch.bfloat16 and out.shape == (16, 32)
