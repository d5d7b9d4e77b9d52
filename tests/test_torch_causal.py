"""The causal text model: ``RobertaEncoder(causal=True)``, ``UniXcoderLM``
and ``beam_search_generate`` against the JAX package on the CPU.

The variables are drawn from a numpy seed, run through the JAX module
(the fused MLP through the Pallas ``mlp_ln_res`` in interpret mode) and
loaded into the port through ``jax_variables_to_torch``. Tolerance: fp32
on both sides, atol 1e-5 (different summation orders; the logits are
O(1)). Beam search must return the same ids: both sides take
``np.argsort(-logp)`` on each row and sort the candidates stably.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_reference import no_persistent_compile_cache  # noqa: F401
from mvuld_tpu_torch.models.convert import (jax_variables_to_torch,
                                            torch_to_jax_names)

ROBERTA = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               intermediate_size=64, max_position_embeddings=40)
TOL = dict(atol=1e-5, rtol=0)


def _variables(model, ids, seed):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), ids))
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(p.key for p in path)
        scale = key.endswith("/scale")
        out[key] = (scale + 0.2 * rng.randn(*leaf.shape)).astype(np.float32)
    return out


def _tree(flat):
    tree = {}
    for k, v in flat.items():
        d = tree
        *path, last = k.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[last] = jnp.asarray(v)
    return tree


def _ids(seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 64, (3, 16)).astype(np.int32)
    ids[0, 11:] = 1
    ids[2, 6:] = 1
    return ids


def _models(fused):
    from mvuld_tpu.models.roberta import RobertaConfig as JCfg
    from mvuld_tpu.models.unixcoder import UniXcoderLM as JLM
    from mvuld_tpu_torch.models.roberta import RobertaConfig
    from mvuld_tpu_torch.models.unixcoder import UniXcoderLM

    jm = JLM(JCfg(**ROBERTA, use_pallas_mlp=fused, pallas_interpret=fused))
    flat = _variables(jm, jnp.asarray(_ids()), seed=5)
    pm = UniXcoderLM(RobertaConfig(**ROBERTA, use_pallas_mlp=fused))
    jax_variables_to_torch(flat, pm)
    return jm, flat, pm


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_causal_encoder_and_lm_logits_match_jax(fused):
    """The causal encoder's hidden states and the LM's tied-head logits on
    padded rows; ``fused`` runs the port's K4 path (plain on the CPU)
    against the Pallas kernel."""
    from mvuld_tpu.models.roberta import RobertaConfig as JCfg
    from mvuld_tpu.models.roberta import RobertaEncoder as JEnc
    from mvuld_tpu_torch.models.roberta import RobertaConfig, RobertaEncoder

    ids = _ids()
    jm, flat, pm = _models(fused)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(
        _tree(flat), jnp.asarray(ids)))
    with torch.no_grad():
        got = pm(torch.as_tensor(ids)).numpy()
    assert got.shape == (3, 16, 64)
    np.testing.assert_allclose(got, want, **TOL)

    je = JEnc(JCfg(**ROBERTA, use_pallas_mlp=fused, pallas_interpret=fused),
              causal=True)
    enc_flat = {k[len("params/encoder/"):]: v for k, v in flat.items()}
    want = np.asarray(jax.jit(lambda v, x: je.apply(v, x))(
        {"params": _tree(enc_flat)}, jnp.asarray(ids)))
    pe = RobertaEncoder(RobertaConfig(**ROBERTA, use_pallas_mlp=fused),
                        causal=True)
    jax_variables_to_torch({"params/" + k: v for k, v in enc_flat.items()},
                           pe)
    with torch.no_grad():
        got = pe(torch.as_tensor(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_future_token_leaves_past_logits_unchanged():
    _, _, pm = _models(False)
    ids = torch.as_tensor(_ids()).long()
    other = ids.clone()
    other[:, 4] = (other[:, 4] + 7) % 60 + 3
    with torch.no_grad():
        a, b = pm(ids), pm(other)
    torch.testing.assert_close(a[:, :4], b[:, :4], rtol=0, atol=0)
    assert (a[:, 4:] - b[:, 4:]).abs().max() > 1e-3


def test_beam_search_ids_match_jax():
    """Three prefixes (one padded) at beam 3, max_length 12; the eos id is
    a token the first prefix's best beam emits, so that beam finishes on
    it and finished beams are carried over."""
    from mvuld_tpu.models.unixcoder import beam_search_generate as jbeam
    from mvuld_tpu_torch.models.unixcoder import beam_search_generate

    jm, flat, pm = _models(False)
    params = _tree(flat)
    apply_fn = jax.jit(lambda v, x: jm.apply(v, x))
    prefix = np.full((3, 6), 1, np.int32)
    prefix[0, :4] = [5, 9, 13, 21]
    prefix[1, :6] = [7, 3, 44, 12, 30, 8]
    prefix[2, :2] = [60, 17]
    free = beam_search_generate(pm, prefix, beam_size=3, max_length=12,
                                eos_id=-1)
    eos = free[0][6]                 # the 3rd generated token of row 0
    got = beam_search_generate(pm, prefix, beam_size=3, max_length=12,
                               eos_id=eos)
    want = jbeam(apply_fn, params, prefix, beam_size=3, max_length=12,
                 eos_id=eos)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) < 12
    assert all(len(g) <= 12 for g in got)


def test_lm_converter_round_trip():
    """JAX variables → the port → back by ``torch_to_jax_names`` (Dense
    kernels transposed back): every key and value returns, and the tied
    head adds no parameter."""
    _, flat, pm = _models(False)
    names = torch_to_jax_names(pm)
    back = {}
    for k, v in pm.state_dict().items():
        a = v.numpy()
        if names[k].endswith("/kernel"):
            a = a.T
        back[names[k]] = a
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert not any(k.startswith("params/lm_head") for k in back)
