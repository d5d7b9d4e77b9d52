"""The port's baseline detectors (``mvuld_tpu_torch/models/baselines.py``,
``DenseGGNN``) against the JAX package's, on the CPU, at small size (N 8
nodes, L 4 tokens, widths ≤ 16).

- Eval-mode forwards on variables drawn from a numpy seed and carried
  across by the converter: ``DenseGGNN``, ``DevignModel``, ``GGNNSum``
  (logits and representations), ``MetricLearningModel``, ``MaskedGRU``
  (rows of length 0 included: flax gives them the state after all L
  steps), ``ChildSumTreeLSTM`` and ``IVDetect``.
- ``reveal_loss`` and its gradients; ``smote`` exactly.
- The gradients of one training step of Devign (BCE) and IVDetect (CE),
  dropout off, as the trainers step them.
- The converter: the same key set both ways (``torch_to_jax_names``),
  ``baseline_params_tree`` back to JAX's tree, and the raises.

Tolerance ``atol=rtol=1e-4`` as in ``tests/test_torch_models.py``: both
sides compute in fp32 in other summation orders. The JAX modules run
eagerly, but IVDetect's forward and the train steps' gradients are jitted
once (faster than eager at these sizes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvuld_tpu.models import baselines as jb
from mvuld_tpu.models.graph_nets import DenseGGNN as JaxGGNN
from mvuld_tpu_torch.models import baselines as pb
from mvuld_tpu_torch.models.convert import (baseline_params_tree,
                                            flatten_variables,
                                            jax_variables_to_torch,
                                            torch_to_jax_names)
from mvuld_tpu_torch.models.graph_nets import DenseGGNN
from jax_reference import (no_persistent_compile_cache,  # noqa: F401
                           one_torch_thread)  # noqa: F401
from test_torch_models import _random_variables, _unflatten

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TOL = dict(atol=1e-4, rtol=1e-4)
B, N, F_IN, D, R, L, H = 3, 8, 6, 10, 6, 4, 8


def _graph(seed=0):
    rng = np.random.RandomState(seed)
    mask = np.zeros((B, N), np.float32)
    for b, n in enumerate((N, 5, 3)):
        mask[b, :n] = 1.0
    feats = rng.randn(B, N, F_IN).astype(np.float32) * mask[..., None]
    adj = (rng.rand(B, R, N, N) < 0.3).astype(np.float32)
    adj *= mask[:, None, :, None] * mask[:, None, None, :]
    return feats, adj, mask


def _ivdetect_inputs(seed=1, feat=F_IN):
    rng = np.random.RandomState(seed)
    _, _, mask = _graph(seed)
    out = []
    for _ in range(4):
        seq = rng.randn(B, N, L, feat).astype(np.float32)
        lens = rng.randint(0, L + 1, (B, N))
        m = (np.arange(L)[None, None] < lens[..., None]).astype(np.float32)
        out += [seq * m[..., None], m]
    ast = np.triu(rng.rand(B, N, N) < 0.3, 1).astype(np.float32)
    adj = (rng.rand(B, N, N) < 0.4).astype(np.float32)
    pair = mask[:, :, None] * mask[:, None, :]
    return out + [ast * pair, adj * pair, mask]


def _pair(jm, pm, args, kwargs=None, seed=3):
    """JAX variables from a numpy seed, loaded into the port module."""
    flat = _random_variables(jm, [jnp.asarray(a) for a in args],
                             kwargs or {}, seed)
    jax_variables_to_torch(flat, pm)
    return flat


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_dense_ggnn_matches_jax():
    feats, adj, mask = _graph()
    jm, pm = JaxGGNN(D, n_steps=3), DenseGGNN(D, n_steps=3)
    flat = _pair(jm, pm, (feats, adj, mask))
    want = jm.apply(_unflatten(flat), *map(jnp.asarray, (feats, adj, mask)))
    _close(pm(*_t((feats, adj, mask))), want)
    # in_feats > out_feats raises on both sides
    with pytest.raises(ValueError, match="in_feats"):
        JaxGGNN(4).init(jax.random.PRNGKey(0), jnp.asarray(feats),
                        jnp.asarray(adj))
    with pytest.raises(ValueError, match="in_feats"):
        DenseGGNN(4)(*_t((feats, adj)))


def test_devign_matches_jax():
    feats, adj, mask = _graph()
    jm = jb.DevignModel(input_dim=F_IN, output_dim=D, num_steps=2)
    pm = pb.DevignModel(input_dim=F_IN, output_dim=D, num_steps=2)
    flat = _pair(jm, pm, (feats, adj, mask))
    want = jm.apply(_unflatten(flat), *map(jnp.asarray, (feats, adj, mask)))
    got = pm(*_t((feats, adj, mask)))
    assert got.shape == (B,)
    _close(got, want)


def test_ggnn_sum_matches_jax():
    feats, adj, mask = _graph()
    jm, pm = jb.GGNNSum(output_dim=D, num_steps=3), pb.GGNNSum(D, 3)
    flat = _pair(jm, pm, (feats, adj, mask))
    j_logits, j_repr = jm.apply(_unflatten(flat),
                                *map(jnp.asarray, (feats, adj, mask)),
                                return_repr=True)
    p_logits, p_repr = pm(*_t((feats, adj, mask)), return_repr=True)
    _close(p_logits, j_logits)
    _close(p_repr, j_repr)
    _close(pm(*_t((feats, adj, mask))), j_logits)


def test_metric_learner_matches_jax():
    x = np.random.RandomState(4).randn(5, D).astype(np.float32)
    jm = jb.MetricLearningModel(hidden_dim=H)
    pm = pb.MetricLearningModel(D, hidden_dim=H)
    flat = _pair(jm, pm, (x,))
    j_logp, j_h = jm.apply(_unflatten(flat), jnp.asarray(x))
    p_logp, p_h = pm(torch.as_tensor(x))
    _close(p_logp, j_logp)
    _close(p_h, j_h)


def test_masked_gru_matches_jax_with_empty_rows():
    rng = np.random.RandomState(5)
    x = rng.randn(6, L, F_IN).astype(np.float32)
    mask = (np.arange(L)[None] < np.array([0, 1, 2, 4, 0, 3])[:, None]
            ).astype(np.float32)
    jm, pm = jb.MaskedGRU(H), pb.MaskedGRU(F_IN, H)
    flat = _pair(jm, pm, (x, mask))
    assert any("GRUCell_0" in k for k in flat)
    want = jm.apply(_unflatten(flat), jnp.asarray(x), jnp.asarray(mask))
    got = pm(*_t((x, mask)))
    _close(got, want)
    # flax selects the carry at length − 1: a length-0 row wraps to the
    # state after all L steps, the same as a full-length row of its inputs
    full = pm(torch.as_tensor(x[[0]]), torch.ones(1, L))
    _close(got[0:1], full.detach().numpy())


def test_tree_lstm_matches_jax():
    *_, ast, _adj, mask = _ivdetect_inputs()
    x = np.random.RandomState(6).randn(B, N, H).astype(np.float32)
    jm, pm = jb.ChildSumTreeLSTM(H), pb.ChildSumTreeLSTM(H, H)
    flat = _pair(jm, pm, (x, ast, mask))
    want = jm.apply(_unflatten(flat), *map(jnp.asarray, (x, ast, mask)))
    _close(pm(*_t((x, ast, mask))), want)


def test_ivdetect_matches_jax():
    inp = _ivdetect_inputs()
    jm = jb.IVDetect(hidden=H, feat_dim=F_IN)
    pm = pb.IVDetect(hidden=H, feat_dim=F_IN)
    flat = _pair(jm, pm, inp)
    want = jax.jit(jm.apply)(_unflatten(flat), *map(jnp.asarray, inp))
    got = pm(*_t(inp))
    assert got.shape == (B, 2)
    _close(got, want)


def test_ivdetect_dropout_draws_from_the_generator():
    """Dropout(0.5) before ``connect`` drops only with a generator (flax's
    ``train=True``), and the same seed drops the same units."""
    inp = _t(_ivdetect_inputs())
    pm = pb.IVDetect(hidden=H, feat_dim=F_IN)
    with torch.no_grad():
        plain = pm(*inp)
        runs = [pm(*inp, gen=torch.Generator().manual_seed(s))
                for s in (1, 1, 2)]
    assert not torch.allclose(runs[0], plain)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_reveal_loss_and_gradients_match_jax():
    rng = np.random.RandomState(7)
    logits = rng.randn(5, 2).astype(np.float32)
    h = [rng.randn(5, H).astype(np.float32) for _ in range(3)]
    y = np.array([0, 1, 1, 0, 1], np.int32)

    def jloss(lg, a, p, n):
        return jb.reveal_loss(jax.nn.log_softmax(lg), a, jnp.asarray(y), p, n)

    j_val, j_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, [logits] + h))
    ts = [torch.tensor(a, requires_grad=True) for a in [logits] + h]
    p_val = pb.reveal_loss(torch.log_softmax(ts[0], -1), ts[1],
                           torch.as_tensor(y), ts[2], ts[3])
    p_grads = torch.autograd.grad(p_val, ts)
    _close(p_val, j_val)
    for g, w in zip(p_grads, j_grads):
        _close(g, w)
    # CE alone without the triplet
    _close(pb.reveal_loss(torch.log_softmax(ts[0], -1), ts[1],
                          torch.as_tensor(y)),
           jb.reveal_loss(jax.nn.log_softmax(jnp.asarray(logits)),
                          jnp.asarray(h[0]), jnp.asarray(y)))


@pytest.mark.parametrize("labels", [[0] * 9 + [1] * 4, [1] * 7 + [0] * 2,
                                    [0] * 5 + [1] * 5, [0] * 6 + [1]])
def test_smote_is_exact(labels):
    labels = np.asarray(labels, np.int32)
    feats = np.random.RandomState(8).randn(len(labels), 5).astype(np.float32)
    jx, jy = jb.smote(feats, labels, np.random.RandomState(9))
    px, py = pb.smote(feats, labels, np.random.RandomState(9))
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)
    assert px.dtype == jx.dtype and py.dtype == jy.dtype


def _grads_by_jax_name(pm, loss):
    names = torch_to_jax_names(pm)
    params = dict(pm.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return {names[n]: g for n, g in zip(params, grads)}


def _jax_kernel_layout(name, g):
    """A port gradient in the JAX leaf's layout."""
    g = g.numpy()
    if name.endswith("/kernel"):
        return g.T if g.ndim == 2 else g.transpose(2, 1, 0)
    return g


@pytest.mark.parametrize("model", ["devign", "ivdetect"])
def test_train_step_gradients_match_jax(model):
    """One step's loss and every parameter gradient, as the trainers
    compute them (BCE mean / softmax CE mean; dropout off)."""
    from mvuld_tpu_torch.train.train_baseline import bce_loss, ce_loss
    if model == "devign":
        inp = list(_graph())
        jm = jb.DevignModel(input_dim=F_IN, output_dim=D, num_steps=2)
        pm = pb.DevignModel(input_dim=F_IN, output_dim=D, num_steps=2)
        keys = ["feats", "adj_etype", "node_mask"]
        y = np.array([1, 0, 1], np.int32)

        def jloss(p):
            logits = jm.apply({"params": p}, *map(jnp.asarray, inp))
            return optax.sigmoid_binary_cross_entropy(
                logits, jnp.asarray(y, jnp.float32)).mean()
        ploss = bce_loss
    else:
        inp = _ivdetect_inputs()
        jm = jb.IVDetect(hidden=H, feat_dim=F_IN)
        pm = pb.IVDetect(hidden=H, feat_dim=F_IN)
        keys = ["f_subseq", "m_subseq", "f_nametype", "m_nametype",
                "f_data", "m_data", "f_control", "m_control", "ast", "adj",
                "node_mask"]
        y = np.array([1, 0, 0], np.int32)

        def jloss(p):
            logits = jm.apply({"params": p}, *map(jnp.asarray, inp))
            return optax.softmax_cross_entropy(
                logits, jax.nn.one_hot(jnp.asarray(y), 2)).mean()
        ploss = ce_loss
    flat = _pair(jm, pm, inp)
    j_val, j_grads = jax.jit(jax.value_and_grad(jloss))(
        _unflatten(flat)["params"])
    j_flat = flatten_variables({"params": j_grads})
    batch = dict(zip(keys, _t(inp)), label=torch.as_tensor(y))
    loss = ploss(pm, batch)
    _close(loss, j_val)
    p_grads = _grads_by_jax_name(pm, loss)
    assert set(p_grads) == set(j_flat)
    for name, g in p_grads.items():
        np.testing.assert_allclose(_jax_kernel_layout(name, g),
                                   np.asarray(j_flat[name]), err_msg=name,
                                   **TOL)


MODELS = {
    "devign": (lambda: jb.DevignModel(input_dim=F_IN, output_dim=D,
                                      num_steps=2),
               lambda: pb.DevignModel(input_dim=F_IN, output_dim=D,
                                      num_steps=2), lambda: _graph()),
    "ggnn_sum": (lambda: jb.GGNNSum(output_dim=D, num_steps=2),
                 lambda: pb.GGNNSum(D, 2), lambda: _graph()),
    "metric": (lambda: jb.MetricLearningModel(hidden_dim=H),
               lambda: pb.MetricLearningModel(D, hidden_dim=H),
               lambda: (np.zeros((2, D), np.float32),)),
    "ivdetect": (lambda: jb.IVDetect(hidden=H, feat_dim=F_IN),
                 lambda: pb.IVDetect(hidden=H, feat_dim=F_IN),
                 _ivdetect_inputs),
}


@pytest.mark.parametrize("key", MODELS)
def test_converter_round_trip(key):
    """``torch_to_jax_names`` gives JAX's key set, and
    ``baseline_params_tree`` gives back JAX's tree."""
    jf, pf, inputs = MODELS[key]
    pm = pf()
    flat = _pair(jf(), pm, inputs())
    assert set(torch_to_jax_names(pm).values()) == set(flat)
    back = flatten_variables({"params": baseline_params_tree(pm)})
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_converter_raises_on_unused_and_unset():
    jf, pf, inputs = MODELS["ivdetect"]
    flat = _random_variables(jf(), [jnp.asarray(a) for a in inputs()], {},
                             3)
    with pytest.raises(KeyError, match="unused"):
        jax_variables_to_torch({**flat, "params/extra/kernel":
                                np.zeros((2, 2), np.float32)}, pf())
    short = {k: v for k, v in flat.items() if "treelstm/U_f" not in k}
    with pytest.raises(KeyError, match="unset"):
        jax_variables_to_torch(short, pf())
    with pytest.raises(TypeError):
        baseline_params_tree(torch.nn.Linear(2, 2))
