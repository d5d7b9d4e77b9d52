"""K optimizer steps per call (``make_multi_train_step``) on the models
with BatchNorm, against the JAX package's ``make_multi_train_step(...,
has_batch_stats=True)``, on the CPU (the port's K steps are K
``train_step`` calls here; the card records them as one CUDA graph:
``tests/test_torch_cuda.py -k multi_step`` and ``chip_smoke.py``'s
``fused_models`` phase).

- The production fusion head ``multi_defect_new_gcn`` at small widths
  (hidden 48: the split projection keeps 32 dims for the boxes, so hidden
  32 is refused by both packages; two Rs-GCN blocks, 12 nodes, batch 4,
  K 3), dropout 0 on both sides, from one set of variables drawn from a numpy seed and
  carried across by ``jax_variables_to_torch``; direct superbatches and
  ``indexed=True`` over device-resident columns, the adjacency bitmask
  filtered as both ``train_fusion`` CLIs filter it.
- The tiny e2e model of ``tests/test_torch_train.py`` with its line
  slots packed (``node_capacity`` 12 < B·N = 24) at K 2; flax's
  ``Dropout`` made the identity and the port run without a generator.
- ``fit`` with fused steps 2 over the fusion head (dropout on, drawn from
  the step generator) on a split that leaves a remainder equals the
  unfused run exactly, direct and with device-resident columns.

Tolerances: each step's loss 1e-5; the final parameters per tensor 1e-5 +
1e-4 · max|w| (fp32 in other summation orders); the BatchNorm running
statistics 1e-4 absolute, as ``tests/test_torch_train.py`` holds one step,
plus 1e-5 of the value (the second Rs-GCN block's variances reach
hundreds here, where fp32 sums differ by 1e-3); the fused and unfused ``fit`` runs exactly. AdamW runs with eps 1e-3
(TRAIN.OPTIMIZER.EPS on both sides): a gradient that vanishes in exact
arithmetic (a bias ahead of a batch-statistics BatchNorm, or one whose
ELU is linear over the whole batch) is rounding noise near 1e-7 on both
sides, and at eps 1e-8 AdamW's division by √v moves its parameter by about
the rate per step in the noise's direction, on each side its own way;
eps 1e-3 leaves such noise at 1e-4 of the rate and real gradients (1e-2
and up) at nearly the full rate. The optimizer itself is held against
optax in ``tests/test_torch_train.py``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu.models.fusion_zoo import FUSION_MODELS as JAX_FUSION
from mvuld_tpu_torch.models.convert import (flatten_variables,
                                            jax_variables_to_torch)
from jax_reference import no_persistent_compile_cache  # noqa: F401
from test_torch_models import _graph_inputs, _random_variables, _unflatten

KEY = "multi_defect_new_gcn"
K, B, N, D, I = 3, 4, 12, 24, 40
SIZES = dict(hidden=48, img_dim=I, text_dim=D, num_rs_gcn=2, num_hidden=2)
NO_DROP = dict(dropout=0.0, final_dropout=0.0)
BITS = 0b0101                       # the edge types the split keeps
LR = 1e-3
EPS = 1e-3                          # AdamW's eps (module docstring)
COLUMNS = ("img_emb", "text_emb", "node_emb", "pos", "adj", "node_mask")


def _fusion_rows(n, seed):
    """``n`` rows of a fusion cache's columns: the adjacency as a uint8
    bitmask of edge types (self-loops in every type), labels 0/1."""
    rng = np.random.RandomState(seed)
    node_emb, pos, adj, node_mask = _graph_inputs(rng, n, N, D)
    bits = rng.randint(0, 16, (n, N, N)).astype(np.uint8)
    bits[:, np.arange(N), np.arange(N)] = 15
    return {"img_emb": rng.randn(n, I).astype(np.float32),
            "text_emb": rng.randn(n, D).astype(np.float32),
            "node_emb": node_emb, "pos": pos,
            "adj": (bits * adj).astype(np.uint8), "node_mask": node_mask,
            "label": rng.randint(0, 2, n).astype(np.int32)}


def _jax_fusion_apply(jm):
    """JAX ``train_fusion``'s apply_fn over ``jm``: the bitmask filtered
    to BITS."""
    def apply_fn(vs, batch, rngs, train, mutable=None):
        kw = {k: batch[k] for k in COLUMNS}
        kw["adj"] = (batch["adj"] & np.uint8(BITS)) != 0
        if mutable:
            return jm.apply(vs, **kw, train=train, rngs=rngs,
                            mutable=mutable)
        return jm.apply(vs, **kw, train=train, rngs=rngs)
    return apply_fn


def _optimizers(jcfg, pcfg, model):
    from mvuld_tpu.core.optim import build_optimizer as jbuild_opt
    from mvuld_tpu_torch.core.optim import build_optimizer
    return (jbuild_opt(jcfg, lambda s: LR),
            build_optimizer(pcfg, lambda count: LR, model))


def _eps(cfgs):
    for cfg in cfgs:
        cfg.defrost()
        cfg.TRAIN.OPTIMIZER.EPS = EPS
        cfg.freeze()
    return cfgs


def _default_cfgs():
    from mvuld_tpu.config import default_config as jdefault
    from mvuld_tpu_torch.config import default_config
    return _eps((jdefault(), default_config()))


def _held_to_jax(model, state, jlosses, losses, fresh):
    """The port's losses, parameters and running statistics after K steps
    against JAX's final ``state`` (carried into ``fresh``, a second port
    model, through the converter)."""
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=0,
                               atol=1e-5)
    assert len(set(np.round(losses, 6).tolist())) > 1
    conv = {"params/" + k: np.asarray(a)
            for k, a in flatten_variables(state.params).items()}
    conv.update({"batch_stats/" + k: np.asarray(a) for k, a in
                 flatten_variables(state.batch_stats).items()})
    jax_variables_to_torch(conv, fresh)
    want, got = fresh.state_dict(), model.state_dict()
    for name, p in model.named_parameters():
        w = want[name]
        err = float((p.detach() - w).abs().max())
        assert err <= 1e-5 + 1e-4 * float(w.abs().max()), (name, err)
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=k)


def _moved(model, start):
    """The running statistics moved from ``start`` (the steps updated
    them)."""
    sd = model.state_dict()
    return all(not torch.equal(sd[k], v) for k, v in start.items()
               if k.endswith("running_mean"))


@pytest.mark.parametrize("indexed", [False, True], ids=["direct", "indexed"])
def test_fusion_head_multi_step_matches_jax(indexed):
    """``multi_defect_new_gcn``: K = 3 fused steps with BatchNorm
    statistics carried through them, against JAX's fused steps."""
    from mvuld_tpu.core.train_state import TrainState
    from mvuld_tpu.core.train_state import (make_multi_train_step as
                                            jmulti)
    from mvuld_tpu_torch.core.train_state import make_multi_train_step
    from mvuld_tpu_torch.models.fusion_zoo import build_fusion_model
    from mvuld_tpu_torch.train.train_fusion import fusion_inputs

    jm = JAX_FUSION.build(KEY, None, **SIZES, **NO_DROP)
    rows = _fusion_rows(2 * K * B if indexed else K * B, seed=3)
    jargs = {k: jnp.asarray(rows[k][:1]) for k in COLUMNS}
    jargs["adj"] = jargs["adj"] > 0
    flat = _random_variables(jm, (), dict(**jargs, train=False), seed=6)
    v = _unflatten(flat)
    assert "batch_stats" in v
    jcfg, pcfg = _default_cfgs()
    pm = build_fusion_model(None, KEY, **SIZES, max_nodes=N, **NO_DROP)
    jax_variables_to_torch(flat, pm)
    start = {k: t.clone() for k, t in pm.state_dict().items()}
    tx, opt = _optimizers(jcfg, pcfg, pm)
    state = TrainState.create(v["params"], tx, batch_stats=v["batch_stats"])
    inputs = fusion_inputs(BITS)

    if indexed:
        idx = np.random.RandomState(4).permutation(len(rows["label"]))[
            :K * B].astype(np.int32).reshape(K, B)
        jstate, jmetrics = jmulti(
            _jax_fusion_apply(jm), tx, K, 0.1, has_batch_stats=True,
            donate=False, indexed=True)(
            state, {"idx": jnp.asarray(idx)}, jax.random.PRNGKey(0),
            {k: jnp.asarray(a) for k, a in rows.items()})
        data = {k: torch.as_tensor(a) for k, a in rows.items()}
        step = make_multi_train_step(pm, opt, K, 0.1, inputs, indexed=True)
        metrics = step({"idx": idx}, None, data)
    else:
        sb = {k: a.reshape(K, B, *a.shape[1:]) for k, a in rows.items()}
        jstate, jmetrics = jmulti(
            _jax_fusion_apply(jm), tx, K, 0.1, has_batch_stats=True,
            donate=False)(state, {k: jnp.asarray(a) for k, a in sb.items()},
                          jax.random.PRNGKey(0))
        step = make_multi_train_step(pm, opt, K, 0.1, inputs)
        metrics = step(sb, None)

    assert metrics["loss"].shape == (K,) and opt.count == K
    assert _moved(pm, start)
    _held_to_jax(pm, jstate, jmetrics["loss"], metrics["loss"].numpy(),
                 build_fusion_model(None, KEY, **SIZES, max_nodes=N,
                                    **NO_DROP))


def test_e2e_packed_multi_step_matches_jax(monkeypatch):
    """The tiny e2e model, lines packed into 12 of 24 slots, K = 2 fused
    steps (the fusion head's BatchNorm statistics carried) against JAX's,
    dropout off on both sides."""
    from mvuld_tpu.core.train_state import TrainState
    from mvuld_tpu.core.train_state import (make_multi_train_step as
                                            jmulti)
    from mvuld_tpu.train.train_e2e import build_e2e_model as jbuild
    from mvuld_tpu_torch.core.train_state import make_multi_train_step
    from test_torch_models import _e2e_inputs
    from test_torch_train import _cfgs, _port_model

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    k, b = 2, 4
    jcfg, pcfg = _eps(_cfgs())
    rows = _e2e_inputs(k * b, jcfg)
    rows["label"] = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int32)
    sb = {key: a.reshape(k, b, *a.shape[1:]) for key, a in rows.items()}
    assert all(sb["node_mask"][i].size > 12 for i in range(k))
    jm, _, _ = jbuild(jcfg, 50, node_capacity=12)
    names = ("func_ids", "node_ids", "image", "pos", "adj", "node_mask")
    first = {key: jnp.asarray(sb[key][0]) for key in names}
    flat = _random_variables(jm, (), dict(**first, train=False), seed=8)
    v = _unflatten(flat)

    def apply_fn(vs, batch, rngs, train, mutable=None):
        kw = {key: batch[key] for key in names}
        if mutable:
            return jm.apply(vs, **kw, train=train, rngs=rngs,
                            mutable=mutable)
        return jm.apply(vs, **kw, train=train, rngs=rngs)

    pm = _port_model(pcfg)
    assert pm.node_capacity == 12
    jax_variables_to_torch(flat, pm)
    start = {key: t.clone() for key, t in pm.state_dict().items()}
    tx, opt = _optimizers(jcfg, pcfg, pm)
    state = TrainState.create(v["params"], tx, batch_stats=v["batch_stats"])
    jstate, jmetrics = jmulti(apply_fn, tx, k, 0.1, has_batch_stats=True,
                              donate=False)(
        state, {key: jnp.asarray(a) for key, a in sb.items()},
        jax.random.PRNGKey(0))
    metrics = make_multi_train_step(pm, opt, k, 0.1)(sb, None)

    assert metrics["loss"].shape == (k,) and opt.count == k
    assert _moved(pm, start)
    _held_to_jax(pm, jstate, jmetrics["loss"], metrics["loss"].numpy(),
                 _port_model(pcfg))


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host_batches", "device_columns"])
def test_fit_fused_fusion_head_equals_unfused(resident):
    """``fit`` over the fusion head with fused steps 2 (two superbatches
    and a remainder step per epoch, dropout drawn from the step
    generator) equals the unfused run exactly: history, parameters and
    running statistics; with ``resident`` the train split lives on the
    device and batches are index vectors (``train_fusion``'s
    TRAIN.DEVICE_DATA)."""
    from mvuld_tpu_torch.config import default_config
    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.train_state import make_multi_train_step
    from mvuld_tpu_torch.data.loader import ArrayDataset
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.fusion_zoo import build_fusion_model
    from mvuld_tpu_torch.train.harness import fit
    from mvuld_tpu_torch.train.train_fusion import fusion_inputs

    cfg = default_config()
    cfg.DATA.BATCH_SIZE = B
    cfg.TRAIN.EPOCHS = 2
    cfg.TRAIN.WARMUP_EPOCHS = 0
    cfg.TRAIN.EARLY_STOP_PATIENCE = 10
    cfg.PRINT_FREQ = 1000
    rows = _fusion_rows(5 * B, seed=9)
    inputs = fusion_inputs(BITS)
    runs = []
    for fused in (1, 2):
        model = build_fusion_model(None, KEY, **SIZES, max_nodes=N)
        init_jax_like(model, torch.Generator().manual_seed(0))
        opt = build_optimizer(cfg, lambda count: LR, model)
        train, data = ArrayDataset(rows), None
        if resident:
            data = {k: torch.as_tensor(a) for k, a in rows.items()}
            train = ArrayDataset({"idx": np.arange(5 * B, dtype=np.int32)})
        multi = (make_multi_train_step(model, opt, fused, 0.1, inputs,
                                       indexed=resident)
                 if fused > 1 else None)
        res = fit(cfg=cfg, model=model, opt=opt, train_ds=train,
                  val_ds=ArrayDataset(rows), device=torch.device("cpu"),
                  device_data=data, inputs=inputs, multi_step=multi,
                  fused_steps=fused)
        runs.append((res, model, opt))
    (r1, m1, o1), (r2, m2, o2) = runs
    assert o1.count == o2.count == 10
    assert r1["history"] == r2["history"]
    s1, s2 = m1.state_dict(), m2.state_dict()
    assert any(k.endswith("running_var") for k in s1)
    for k, t in s1.items():
        assert torch.equal(s2[k], t), k
