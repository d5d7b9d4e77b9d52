"""The port's training path against the JAX package, on the CPU.

- One train step of a tiny ``EndToEndMVulD`` (plain layers, fp32, the
  dropout and DropPath rates at 0; flax's ``Dropout`` is made the identity
  for the fusion head's fixed 0.2): the loss, every parameter gradient and
  the updated BatchNorm statistics against ``jax.value_and_grad`` of the
  JAX model. Tolerances: loss 1e-5; per tensor max|Δg| ≤ 1e-5 + 1e-4 ·
  max|g_jax| (fp32 in other summation orders; the absolute term covers
  gradients that vanish in exact arithmetic, such as a bias feeding a
  batch-statistics BatchNorm, which both sides return as rounding noise
  near 1e-6); BatchNorm statistics 1e-4.
- The kernel path (K1/K2, K3/K3b, K4/K4b through their autograd
  functions, plain versions on the CPU) against the plain layers with
  dropout and DropPath on, both drawing from equally seeded generators.
- Activation checkpointing changes no gradient and never reruns K1.
- AdamW / SGD-Nesterov with clipping and MultiSteps against optax; the
  schedules against optax; the decay mask against JAX's through the name
  map; a checkpoint save and resume round trip.
- The trainer CLI on a tiny synthetic corpus against JAX's
  ``train_e2e.main``.
"""

import json
import os
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvuld_tpu_torch.models.convert import (flatten_variables,
                                            jax_variables_to_torch,
                                            torch_to_jax_names)
from jax_reference import no_persistent_compile_cache  # noqa: F401
from test_torch_models import (E2E_OPTS, _e2e_inputs, _random_variables,
                               _unflatten)

OPTS = E2E_OPTS + ["MODEL.DROP_PATH_RATE", "0.0"]
LABELS = np.array([0, 1, 1, 0], np.int32)


def _cfgs(opts=OPTS):
    from mvuld_tpu.config import get_config as jget
    from mvuld_tpu_torch.config import get_config as pget
    ns = SimpleNamespace(cfg=None, opts=opts, output="unused")
    return jget(ns), pget(ns)


def _port_model(pcfg, **kw):
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model
    return build_e2e_model(pcfg, 50, node_capacity=12, **kw)[0]


def _batch(inp):
    return {k: torch.as_tensor(v) for k, v in inp.items()}


def _grads(model, batch, gen=None):
    from mvuld_tpu_torch.core.train_state import cross_entropy, model_inputs
    logits = model(**model_inputs(batch), train=True, gen=gen)
    loss = cross_entropy(logits, torch.as_tensor(LABELS), 0.1)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


def test_train_step_matches_jax_value_and_grad(monkeypatch):
    from mvuld_tpu.core.train_state import cross_entropy as jce
    from mvuld_tpu.train.train_e2e import build_e2e_model as jbuild

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    jcfg, pcfg = _cfgs()
    inp = _e2e_inputs(4, jcfg)
    jm, _, _ = jbuild(jcfg, 50, node_capacity=12)
    jargs = {k: jnp.asarray(v) for k, v in inp.items()}
    flat = _random_variables(jm, (), dict(**jargs, train=False), seed=8)
    v = _unflatten(flat)

    def loss_fn(params):
        logits, mut = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, **jargs,
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return jce(logits, jnp.asarray(LABELS), 0.1), mut

    (jloss, mut), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        v["params"])

    pm = _port_model(pcfg)
    jax_variables_to_torch(flat, pm)
    loss, grads = _grads(pm, _batch(inp))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)

    # JAX's gradients and new statistics in the port's layout, through the
    # converter: loaded as the "parameters" of a second port model
    ref = _port_model(pcfg)
    conv = {"params/" + k: np.asarray(a)
            for k, a in flatten_variables(jgrads).items()}
    conv.update({"batch_stats/" + k: np.asarray(a)
                 for k, a in flatten_variables(mut["batch_stats"]).items()})
    jax_variables_to_torch(conv, ref)
    want = ref.state_dict()
    assert set(grads) <= set(want)
    for name, g in grads.items():
        w = want[name]
        err = float((g - w).abs().max())
        assert err <= 1e-5 + 1e-4 * float(w.abs().max()), (name, err)
    got = pm.state_dict()
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-4, err_msg=k)


def test_kernel_path_grads_match_plain_layers_with_dropout():
    """Same weights, dropout 0.1 (text), 0.2 (head) and DropPath 0.2 from
    two generators seeded alike: the masks agree, so the kernel path's
    loss and gradients sit within the two attention numerics' 1e-4 of the
    plain path (a differently drawn mask would move them by far more)."""
    from mvuld_tpu_torch.models.convert import init_jax_like

    _, pcfg = _cfgs(E2E_OPTS + ["MODEL.DROP_PATH_RATE", "0.2"])
    inp = _e2e_inputs(4, pcfg)
    plain = _port_model(pcfg)
    init_jax_like(plain, torch.Generator().manual_seed(0))
    fast = _port_model(pcfg, use_pallas=True, use_pallas_mlp=True,
                       roberta_pallas_mlp=True)
    fast.load_state_dict(plain.state_dict())
    lp, gp = _grads(plain, _batch(inp), torch.Generator().manual_seed(3))
    lk, gk = _grads(fast, _batch(inp), torch.Generator().manual_seed(3))
    np.testing.assert_allclose(lk.item(), lp.item(), atol=1e-4)
    for name, g in gp.items():
        err = float((gk[name] - g).abs().max())
        assert err <= 1e-4 * (1 + float(g.abs().max())), (name, err)


def test_checkpointed_stages_keep_grads_and_never_rerun_k1(monkeypatch):
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.ops import window_attention as wa

    _, pcfg = _cfgs(E2E_OPTS + ["MODEL.DROP_PATH_RATE", "0.2"])
    inp = _e2e_inputs(4, pcfg)
    calls = []
    k1 = wa.window_attention_flat
    monkeypatch.setattr(wa, "window_attention_flat",
                        lambda *a, **k: calls.append(1) or k1(*a, **k))
    kw = dict(use_pallas=True, use_pallas_mlp=True)
    base = _port_model(pcfg, **kw)
    init_jax_like(base, torch.Generator().manual_seed(0))
    remat = _port_model(pcfg, swin_remat_stages=(0, 1), **kw)
    remat.load_state_dict(base.state_dict())
    _, g0 = _grads(base, _batch(inp), torch.Generator().manual_seed(4))
    n0 = len(calls)
    _, g1 = _grads(remat, _batch(inp), torch.Generator().manual_seed(4))
    assert n0 == 4 and len(calls) == 2 * n0     # one K1 per block, each run
    for name, g in g0.items():
        torch.testing.assert_close(g1[name], g, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------ optim

def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"w": (scale * rng.randn(6, 5)).astype(np.float32),
            "norm_scale": (scale * rng.randn(5)).astype(np.float32),
            "kernel": (scale * rng.randn(4, 3, 2)).astype(np.float32)}


OPTAX_CASES = {"adamw_clip": ("adamw", 1), "sgd_nesterov_clip": ("sgd", 1),
               "adamw_multisteps2": ("adamw", 2)}
OPTAX_SCHEDULE = (1e-2, 1e-4, 1e-5, 2, 10)    # cosine_schedule's arguments
OPTAX_MASK = {"w": True, "norm_scale": False, "kernel": True}
OPTAX_SCALES = (3.0, 0.1, 2.0, 0.5)           # the gradients' scales, by step
OPTAX_STEPS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "optax_steps.json")


def _optax_steps(name, k):
    """optax's parameters after each of four updates: clip at 5 (the
    gradient norms straddle it), a warmup cosine schedule, decay masked
    off one parameter; ``k`` > 1 inside MultiSteps."""
    from mvuld_tpu.core.schedule import cosine_schedule as jcosine

    jsched = jcosine(*OPTAX_SCHEDULE)      # traceable, for optax
    if name == "adamw":
        inner = optax.adamw(jsched, b1=0.9, b2=0.999, eps=1e-8,
                            weight_decay=0.05, mask=OPTAX_MASK)
    else:
        inner = optax.chain(optax.add_decayed_weights(0.05, mask=OPTAX_MASK),
                            optax.sgd(jsched, momentum=0.9, nesterov=True))
    tx = optax.chain(optax.clip_by_global_norm(5.0), inner)
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k)
    params = {n: jnp.asarray(a) for n, a in _tree(0).items()}
    state = tx.init(params)
    out = []
    for step, scale in enumerate(OPTAX_SCALES):
        g = _tree(10 + step, scale)
        upd, state = tx.update({n: jnp.asarray(a) for n, a in g.items()},
                               state, params)
        params = optax.apply_updates(params, upd)
        out.append({n: np.asarray(a) for n, a in params.items()})
    return out


def optax_steps_fixture():
    """``tests/fixtures/optax_steps.json``: the inputs of
    ``test_optimizer_steps_match_optax`` and optax's parameters after each
    step in each case, flat fp32 values, so that a machine without JAX
    (``tests/test_torch_cuda.py`` on the card) holds the optimizer to
    optax. Write it anew with ``json.dump(optax_steps_fixture(), f)``."""
    flat = lambda tree: {n: a.astype(np.float32).ravel().tolist()  # noqa: E731
                         for n, a in tree.items()}
    return {"schedule": list(OPTAX_SCHEDULE), "mask": OPTAX_MASK,
            "weight_decay": 0.05, "clip": 5.0,
            "shapes": {n: list(a.shape) for n, a in _tree(0).items()},
            "params": flat(_tree(0)),
            "grads": [flat(_tree(10 + i, sc))
                      for i, sc in enumerate(OPTAX_SCALES)],
            "cases": {case: {"name": name, "k": k,
                             "steps": [flat(t) for t in _optax_steps(name, k)]}
                      for case, (name, k) in OPTAX_CASES.items()}}


@pytest.mark.parametrize("name,k", list(OPTAX_CASES.values()),
                         ids=list(OPTAX_CASES))
def test_optimizer_steps_match_optax(name, k):
    """Three updates (the gradient norms straddle the clip at 5) with a
    warmup schedule and decay masked off one parameter: parameters within
    1e-6 of optax."""
    from mvuld_tpu_torch.core.optim import Optimizer
    from mvuld_tpu_torch.core.schedule import cosine_schedule

    sched = cosine_schedule(*OPTAX_SCHEDULE)
    tp = {n: torch.tensor(a) for n, a in _tree(0).items()}
    opt = Optimizer(list(tp.items()), OPTAX_MASK, sched, name=name,
                    weight_decay=0.05, clip=5.0, accumulation_steps=k)
    for step, (scale, params) in enumerate(zip(OPTAX_SCALES,
                                               _optax_steps(name, k))):
        g = _tree(10 + step, scale)
        opt.update([torch.as_tensor(g[n]) for n in tp])
        for n in tp:
            np.testing.assert_allclose(tp[n].numpy(), params[n],
                                       atol=1e-6, rtol=1e-6, err_msg=n)


def test_optax_steps_fixture_is_optax():
    """The recorded fixture that the card's optimizer test reads holds
    these inputs and optax's parameters to the bit."""
    with open(OPTAX_STEPS) as f:
        assert json.load(f) == optax_steps_fixture()


@pytest.mark.parametrize("k", [1, 2], ids=["single", "multisteps2"])
def test_train_step_grad_norm_is_the_raw_gradients_norm(k):
    """``train_step`` takes its grad_norm from the clip's norm at k = 1
    and computes it apart under MultiSteps (where the clip reads the
    accumulated gradient): either way it equals ``global_norm`` of the
    batch's raw gradients, on both sides of the clip at 5."""
    from mvuld_tpu_torch.core.optim import Optimizer, global_norm
    from mvuld_tpu_torch.core.train_state import train_step

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(_tree(0)["w"]))
            self.norm_scale = torch.nn.Parameter(torch.ones(5))

        def forward(self, x, train, gen):
            return (x @ self.w) * self.norm_scale

    model = Tiny()
    params = list(model.named_parameters())
    opt = Optimizer(params, {n: n == "w" for n, _ in params},
                    lambda count: 1e-2, weight_decay=0.05, clip=5.0,
                    accumulation_steps=k)
    seen, update = [], opt.update

    def record(grads):
        seen.append([g.clone() for g in grads])
        return update(grads)

    opt.update = record
    rng = np.random.RandomState(1)
    norms = []
    for scale in (30.0, 0.1, 30.0, 0.1):
        batch = {"x": torch.tensor(scale * rng.randn(4, 6), dtype=torch.float32),
                 "label": torch.tensor(rng.randint(0, 5, 4))}
        m = train_step(model, opt, batch, None, 0.1,
                       inputs=lambda b: {"x": b["x"]})
        assert torch.equal(m["grad_norm"], global_norm(seen[-1]))
        norms.append(float(m["grad_norm"]))
    assert min(norms) < 5.0 < max(norms)
    assert opt.count == 4 // k


@pytest.mark.parametrize("name", ["cosine", "linear", "step"])
def test_schedules_match_optax(name):
    from mvuld_tpu.core import schedule as js
    from mvuld_tpu_torch.core import schedule as ps

    kw = dict(decay_steps=7, decay_rate=0.5) if name == "step" else {}
    for warm in (0, 5):
        mine = ps.SCHEDULERS[name](1e-3, 1e-5, 1e-6, warm, 40, **kw)
        ref = getattr(js, f"{name}_schedule")(1e-3, 1e-5, 1e-6, warm, 40,
                                              **kw)
        for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
            # optax evaluates in fp32, the port in Python floats
            np.testing.assert_allclose(mine(step), float(ref(step)),
                                       rtol=2e-5, atol=1e-12)


def test_decay_mask_matches_jax_through_the_name_map():
    from mvuld_tpu.core.optim import decay_mask as jmask
    from mvuld_tpu.train.train_e2e import build_e2e_model as jbuild
    from mvuld_tpu_torch.core.optim import decay_mask

    jcfg, pcfg = _cfgs()
    inp = {k: jnp.asarray(v) for k, v in _e2e_inputs(1, jcfg).items()}
    jm, _, _ = jbuild(jcfg, 50, node_capacity=12)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), **inp,
                                            train=False))["params"]
    want = {"params/" + k: bool(v)
            for k, v in flatten_variables(jmask(params)).items()}
    pm = _port_model(pcfg)
    names = torch_to_jax_names(pm)
    got = decay_mask(pm)
    assert {names[n] for n in got} == set(want)
    assert {n: want[names[n]] for n in got} == got
    assert any(got.values()) and not all(got.values())


def test_name_map_inverts_the_converter():
    """Every port tensor's JAX path maps back onto that tensor."""
    _, pcfg = _cfgs()
    pm = _port_model(pcfg)
    names = torch_to_jax_names(pm)
    sd = pm.state_dict()
    assert set(names) == {k for k in sd if "num_batches" not in k}
    flat = {}
    for key, path in names.items():
        t = sd[key].numpy()
        flat[path] = np.full(t.T.shape if t.ndim == 2 and
                             path.endswith("kernel") else t.shape, 0.5,
                             np.float32)
    # the converter rebuilds the JAX shapes' transposes: load them back
    ref = _port_model(pcfg)
    with pytest.raises((ValueError, KeyError)) as e:
        jax_variables_to_torch({"params/not/a/path": np.zeros(1)}, ref)
    assert "unused" in str(e.value)
    for key, path in names.items():
        assert path.startswith(("params/", "batch_stats/"))
        assert ("running_" in key) == path.startswith("batch_stats/")


# ------------------------------------------------------------- checkpoints

def test_checkpoint_round_trip_and_resume_ladder(tmp_path):
    from mvuld_tpu_torch.core.checkpoint import (restore, resume_ladder,
                                                 save_checkpoint)
    from mvuld_tpu_torch.core.optim import Optimizer, decay_mask
    from mvuld_tpu_torch.core.train_state import train_step
    from mvuld_tpu_torch.models.convert import init_jax_like

    _, pcfg = _cfgs()
    inp = _e2e_inputs(4, pcfg)
    batch = {**_batch(inp), "label": torch.as_tensor(LABELS)}

    def fresh():
        m = _port_model(pcfg)
        init_jax_like(m, torch.Generator().manual_seed(0))
        o = Optimizer(list(m.named_parameters()), decay_mask(m),
                      lambda c: 1e-3, weight_decay=0.05)
        return m, o

    model, opt = fresh()
    train_step(model, opt, batch, None)
    path = save_checkpoint(str(tmp_path), 3, {
        "params": model.state_dict(), "opt_state": opt.state_dict(),
        "step": opt.count, "epoch": 3, "best_f1": 0.25}, best=True)
    assert path.endswith(os.path.join("checkpoint-best-f1",
                                      "best_f1_epoch_3"))
    assert resume_ladder(str(tmp_path)) == path
    assert resume_ladder(str(tmp_path), best_resume=False) is None
    model2, opt2 = fresh()
    meta = restore(path, model2, opt2)
    assert meta == {"epoch": 3, "best_f1": 0.25, "step": 1}
    for k, v in model.state_dict().items():
        torch.testing.assert_close(model2.state_dict()[k], v)
    assert opt2.count == 1
    for a, b in zip(opt.nu, opt2.nu):
        torch.testing.assert_close(a, b)
    # the next step from the restored state equals the uninterrupted one
    m1 = train_step(model, opt, batch, None)
    m2 = train_step(model2, opt2, batch, None)
    torch.testing.assert_close(m1["loss"], m2["loss"])
    for a, b in zip(opt.params, opt2.params):
        torch.testing.assert_close(a, b)


# ---------------------------------------------------------------- trainer

TINY = ["MODEL.UNIXCODER.LAYERS", "1", "MODEL.UNIXCODER.HIDDEN", "32",
        "MODEL.UNIXCODER.HEADS", "2", "MODEL.UNIXCODER.INTERMEDIATE", "64",
        "DATA.IMG_SIZE", "32", "DATA.FUNC_TOKENS", "64",
        "DATA.NODE_TOKENS", "16", "DATA.MAX_NODES", "24",
        "MODEL.SWINV2.EMBED_DIM", "16", "MODEL.SWINV2.DEPTHS", "[1,1]",
        "MODEL.SWINV2.NUM_HEADS", "[2,2]", "MODEL.SWINV2.WINDOW_SIZE", "4",
        "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", "[0,0]",
        "MODEL.MULTI.HIDDEN", "64", "MODEL.MULTI.NUM_RS_GCN", "1",
        "MODEL.MULTI.NUM_HIDDEN_FC", "1", "MODEL.DROP_PATH_RATE", "0.0",
        "TRAIN.EPOCHS", "3", "TRAIN.WARMUP_EPOCHS", "1",
        "TRAIN.BASE_LR", "2e-3", "TRAIN.WARMUP_LR", "1e-4",
        "TRAIN.MIN_LR", "1e-4", "TRAIN.EARLY_STOP_PATIENCE", "20",
        "PARALLEL.DTYPE", "float32", "PRINT_FREQ", "50"]


def _first_losses(log_path):
    out = []
    with open(log_path) as f:
        for line in f:
            if " it 0: loss " in line:
                out.append(float(line.split(" it 0: loss ")[1].split()[0]))
    return out


def test_trainer_cli_runs_and_matches_jax_first_losses(tmp_path,
                                                       monkeypatch):
    """``--synthetic 48 --batch-size 8`` with the tiny config (a copy of
    tests/test_train_e2e.py's ``_tiny_opts``) on the CPU: the port's CLI
    writes ``history.json`` and its checkpoints, and its logged losses (the
    first step of each of the 3 epochs) match JAX's ``train_e2e.main``
    within 5e-4. Both build the same corpus, tokenizer, cache, split
    (39/5/4) and batch order; the port starts from JAX's initial variables
    (the same ``model.init`` JAX's main runs), and dropout is the identity
    on both sides, since the two frameworks draw different masks. The
    losses are logged to 4 decimals and drift apart by fp32 rounding over
    the run's 12 optimizer steps."""
    from mvuld_tpu.train.train_e2e import build_e2e_model as jbuild
    from mvuld_tpu.train.train_e2e import main as jmain
    from mvuld_tpu_torch.data.tokenizer import vocab_size_of
    from mvuld_tpu_torch.models import convert, dropout
    from mvuld_tpu_torch.train.train_e2e import main as pmain

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(dropout, "apply_keep", lambda x, mask, rate: x)
    common = ["--synthetic", "48", "--batch-size", "8", "--opts", *TINY]
    jres = jmain(["--output", str(tmp_path / "jax"), *common])
    sub = os.path.join("swinv2_base_patch4_window24to28", "default")
    jrun = os.path.join(str(tmp_path / "jax"), sub)

    jcfg, _ = _cfgs(TINY + ["DATA.BATCH_SIZE", "8"])
    vocab = vocab_size_of(os.path.join(jrun, "tokenizer.json"))
    jm, _, _ = jbuild(jcfg, vocab, node_capacity=128, scan_blocks=True)
    M, T, Tn, S = (jcfg.DATA.MAX_NODES, jcfg.DATA.FUNC_TOKENS,
                   jcfg.DATA.NODE_TOKENS, jcfg.DATA.IMG_SIZE)
    init = jm.init(jax.random.PRNGKey(jcfg.SEED),
                   func_ids=jnp.zeros((1, T), jnp.int32),
                   node_ids=jnp.zeros((1, M, Tn), jnp.int32),
                   image=jnp.zeros((1, S, S, 3)), pos=jnp.zeros((1, M, 4)),
                   adj=jnp.zeros((1, M, M), bool),
                   node_mask=jnp.zeros((1, M)), train=False)
    flat = flatten_variables(jax.device_get(init))
    monkeypatch.setattr(convert, "init_jax_like",
                        lambda model, gen: jax_variables_to_torch(flat,
                                                                  model))
    res = pmain(["--output", str(tmp_path / "port"), "--device", "cpu",
                 *common])
    run = os.path.join(str(tmp_path / "port"), sub)
    with open(os.path.join(run, "history.json")) as f:
        hist = json.load(f)
    assert len(hist["history"]) == 3 and res["history"] == hist["history"]
    assert all(np.isfinite(h["f1"]) for h in hist["history"])
    assert res.get("test_metrics") is not None
    assert os.listdir(os.path.join(run, "checkpoints"))
    assert os.listdir(os.path.join(run, "checkpoint-best-f1"))
    mine = _first_losses(os.path.join(run, "log_rank0.txt"))
    ref = _first_losses(os.path.join(jrun, "log_rank0.txt"))
    assert len(mine) == len(ref) == 3
    np.testing.assert_allclose(mine, ref, atol=5e-4)
    assert len(jres["history"]) == len(res["history"])
