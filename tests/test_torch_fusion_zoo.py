"""The port's fusion-model zoo and bilinear operators against the JAX
package, on the CPU, at small size (hidden 64, 8 nodes, two Rs-GCN blocks,
two hidden FCs; node width 60 so that ``multi_defect_gatpos``'s D − 48
projection has room).

- Every key of the JAX ``FUSION_MODELS``: eval logits on variables drawn
  from a numpy seed (non-trivial BatchNorm statistics); one train-mode
  step with ``dropout=0, final_dropout=0`` (logits, the smoothed loss,
  every parameter gradient, the updated statistics) against
  ``jax.value_and_grad``; the converter's round trip (the same key set,
  the same values).
- ``multi_defect_allnode`` with node types outside [0, 32): zero one-hot
  rows, as ``jax.nn.one_hot`` gives them.
- Each operator of ``BILINEAR_FUSIONS``: its output and the gradients of
  its inputs and parameters, and its constructor defaults.
- ``train_fusion.main --arch multi_defect_allnode`` (reads ``ntype``) on a
  seeded cache against JAX's CLI from JAX's initial variables, with
  device-resident splits off and on.

Tolerance ``atol=rtol=1e-4`` as in ``tests/test_torch_models.py``: both
sides compute in fp32 in other summation orders. The JAX modules run
eagerly (no jit): each is small.
"""

import dataclasses
import inspect
import os
from functools import lru_cache
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu.models.bilinear_fusion import BILINEAR_FUSIONS as JAX_BILINEAR
from mvuld_tpu.models.fusion_zoo import FUSION_MODELS as JAX_FUSION
from mvuld_tpu_torch.models.convert import (flatten_variables,
                                            jax_variables_to_torch,
                                            torch_to_jax_names)
from jax_reference import no_persistent_compile_cache  # noqa: F401
from test_torch_models import _graph_inputs, _random_variables, _unflatten

TOL = dict(atol=1e-4, rtol=1e-4)
KEYS = JAX_FUSION.keys()
B, N, D, I = 4, 8, 60, 40
SIZES = dict(hidden=64, img_dim=I, text_dim=D, num_rs_gcn=2, num_hidden=2)
LABELS = np.array([0, 1, 1, 0], np.int32)


def _inputs(seed=5):
    rng = np.random.RandomState(seed)
    node_emb, pos, adj, node_mask = _graph_inputs(rng, B, N, D)
    ntype = (rng.randint(0, 32, (B, N)) * node_mask).astype(np.int32)
    return dict(img_emb=rng.randn(B, I).astype(np.float32),
                text_emb=rng.randn(B, D).astype(np.float32),
                node_emb=node_emb, pos=pos, adj=adj, node_mask=node_mask,
                ntype=ntype)


def _models(key, **kw):
    from mvuld_tpu_torch.models.fusion_zoo import build_fusion_model
    jm = JAX_FUSION.build(key, None, **SIZES, **kw)
    pm = build_fusion_model(None, key, **SIZES, max_nodes=N, **kw)
    return jm, pm


@lru_cache(maxsize=None)
def _variables(key):
    jm, _ = _models(key)
    jargs = {k: jnp.asarray(v) for k, v in _inputs().items()}
    return _random_variables(jm, (), dict(**jargs, train=False), seed=6)


def _run(jm, pm, flat, inp, train):
    """JAX's and the port's logits on ``inp`` (eval) from ``flat``."""
    ref = np.asarray(jm.apply(_unflatten(flat),
                              **{k: jnp.asarray(v) for k, v in inp.items()},
                              train=train))
    jax_variables_to_torch(flat, pm)
    with torch.no_grad():
        out = pm(**{k: torch.as_tensor(v) for k, v in inp.items()},
                 train=train).numpy()
    return out, ref


@pytest.mark.parametrize("key", KEYS)
def test_eval_logits_match_jax(key):
    jm, pm = _models(key)
    flat = _variables(key)
    out, ref = _run(jm, pm, flat, _inputs(), train=False)
    assert out.shape == (B, 2)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("key", KEYS)
def test_train_step_matches_jax(key):
    """One train-mode step, dropout 0: logits, loss, every parameter
    gradient (JAX's through the converter into a second port model) and
    the BatchNorm statistics after the step."""
    from mvuld_tpu.core.train_state import cross_entropy as jce
    from mvuld_tpu_torch.core.train_state import cross_entropy

    no_drop = dict(dropout=0.0, final_dropout=0.0)
    jm, pm = _models(key, **no_drop)
    flat = _variables(key)
    v = _unflatten(flat)
    stats = v.get("batch_stats", {})
    inp = _inputs()
    jargs = {k: jnp.asarray(a) for k, a in inp.items()}

    def loss_fn(params):
        logits, mut = jm.apply({"params": params, "batch_stats": stats},
                               **jargs, train=True, mutable=["batch_stats"])
        return jce(logits, jnp.asarray(LABELS), 0.1), (logits, mut)

    (jloss, (jlogits, mut)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(v["params"])

    jax_variables_to_torch(flat, pm)
    logits = pm(**{k: torch.as_tensor(a) for k, a in inp.items()},
                train=True)
    loss = cross_entropy(logits, torch.as_tensor(LABELS), 0.1)
    names, params = zip(*pm.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)

    _, ref = _models(key, **no_drop)
    conv = {"params/" + k: np.asarray(a)
            for k, a in flatten_variables(jgrads).items()}
    conv.update({"batch_stats/" + k: np.asarray(a) for k, a in
                 flatten_variables(mut.get("batch_stats", {})).items()})
    jax_variables_to_torch(conv, ref)
    want = ref.state_dict()
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
    got = pm.state_dict()
    stats_keys = [k for k in got if k.endswith(("running_mean",
                                                "running_var"))]
    assert bool(stats_keys) == bool(stats)
    for k in stats_keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("key", KEYS)
def test_converter_round_trip(key):
    """JAX variables → port → JAX names: the same key set, and each port
    tensor holds the values of the JAX variable it names (in its layout)."""
    _, pm = _models(key)
    flat = _variables(key)
    jax_variables_to_torch(flat, pm)
    names = torch_to_jax_names(pm)
    assert sorted(names.values()) == sorted(flat)
    sd = pm.state_dict()
    for port_key, jax_key in names.items():
        np.testing.assert_array_equal(np.sort(sd[port_key].numpy(), None),
                                      np.sort(flat[jax_key], None),
                                      err_msg=port_key)


def test_build_fusion_model_keys_match_jax():
    """The port registers the JAX keys; flags that would give two modules
    the name ``hfc`` (a flax name clash) raise."""
    from mvuld_tpu_torch.models.fusion_zoo import (FUSION_MODELS,
                                                   build_fusion_model)
    assert FUSION_MODELS.keys() == KEYS
    assert len(KEYS) == 23
    with pytest.raises(ValueError, match="hfc"):
        build_fusion_model(None, "multi_defect_gatpos", readout="gru")


@pytest.mark.parametrize("key,unused", [
    ("motivation_image", ("text_emb", "node_emb", "pos", "adj", "node_mask",
                          "ntype")),
    ("motivation_functext", ("img_emb", "node_emb", "pos", "adj",
                             "node_mask", "ntype")),
    ("multi_defect_nograph", ("node_emb", "pos", "adj", "node_mask",
                              "ntype"))])
def test_unused_inputs_may_be_none(key, unused):
    _, pm = _models(key)
    jax_variables_to_torch(_variables(key), pm)
    inp = {k: torch.as_tensor(v) for k, v in _inputs().items()}
    with torch.no_grad():
        want = pm(**inp)
        got = pm(**{k: None if k in unused else v for k, v in inp.items()})
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_allnode_out_of_range_ntype_gives_zero_rows():
    """Node types −1, 32, 40 and 1000 one-hot to zero rows, as
    ``jax.nn.one_hot`` gives them (``F.one_hot`` would raise): the logits
    match JAX's, and other ids outside [0, 32) give the same logits."""
    jm, pm = _models("multi_defect_allnode")
    flat = _variables("multi_defect_allnode")
    inp = _inputs()
    inp["ntype"] = inp["ntype"].copy()
    inp["ntype"][0, :3] = [-1, 32, 40]
    inp["ntype"][2, 1] = 1000
    out, ref = _run(jm, pm, flat, inp, train=False)
    np.testing.assert_allclose(out, ref, **TOL)
    inp["ntype"][0, :3] = [-7, 33, 99]
    inp["ntype"][2, 1] = -1000
    again, _ = _run(jm, pm, flat, inp, train=False)
    np.testing.assert_array_equal(again, out)


def test_final_dropout_drops_logits_in_training_only():
    """``multi_defect_grudot``'s final dropout 0.3 acts on the logits:
    with a generator in training each logit is 0 or scaled by 1/0.7; in
    eval the generator changes nothing."""
    _, pm = _models("multi_defect_grudot", dropout=0.0)
    jax_variables_to_torch(_variables("multi_defect_grudot"), pm)
    inp = {k: torch.as_tensor(v) for k, v in _inputs().items()}
    with torch.no_grad():
        base = pm(**inp, train=True)
        dropped = pm(**inp, train=True, gen=torch.Generator().manual_seed(0))
        kept = dropped != 0
        assert kept.any() and not kept.all()
        torch.testing.assert_close(dropped[kept], base[kept] / 0.7)
        torch.testing.assert_close(
            pm(**inp, gen=torch.Generator().manual_seed(0)), pm(**inp))


def test_init_jax_like_gru_and_tucker_cores():
    """flax's initialisers for the new leaves: the GRU's recurrent kernels
    orthogonal, its input kernels lecun-normal, every bias 0; Tucker
    cores normal with std 0.02."""
    from mvuld_tpu_torch.models.bilinear_fusion import build_bilinear_fusion
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.fusion_zoo import build_fusion_model

    gen = torch.Generator().manual_seed(0)
    m = build_fusion_model(None, "multi_defect_grudot", hidden=128,
                           img_dim=I, text_dim=D, num_rs_gcn=1, num_hidden=1,
                           max_nodes=N)
    init_jax_like(m, gen)
    gru = m.graph.gru._modules
    for gate in ("hr", "hz", "hn"):
        w = gru[gate].weight
        torch.testing.assert_close(w @ w.T, torch.eye(128), atol=1e-5,
                                   rtol=0)
    assert gru["hr"].bias is None and gru["hz"].bias is None
    assert not gru["hn"].bias.any() and not gru["in"].bias.any()
    std = float(gru["ir"].weight.detach().std())
    assert abs(std - 128 ** -0.5) < 0.1 * 128 ** -0.5
    for name, kw in (("tucker", {}), ("block_tucker", dict(mm_dim=256))):
        op = build_bilinear_fusion(name, input_dims=(12, 10), **kw)
        init_jax_like(op, gen)
        cores = [p for n, p in op.named_parameters() if n.startswith("core")]
        assert cores
        for c in cores:
            c = c.detach()
            assert abs(float(c.std()) - 0.02) < 2e-3
            assert abs(float(c.mean())) < 2e-3


# ------------------------------------------------------------ bilinear

PAIR = dict(input_dims=(12, 10), output_dim=8, mm_dim=16)
BILINEAR = {"linear_sum": PAIR, "concat_mlp": dict(PAIR, hidden=24),
            "mlb": PAIR, "mfb": PAIR, "mfh": PAIR, "mutan": PAIR,
            "tucker": dict(PAIR, core_dim=6), "block": PAIR,
            "block_tucker": PAIR,
            "relational_network": dict(output_dim=8, hidden=16)}


def test_bilinear_registry_matches_jax():
    from mvuld_tpu_torch.models.bilinear_fusion import BILINEAR_FUSIONS
    assert BILINEAR_FUSIONS.keys() == JAX_BILINEAR.keys() == sorted(BILINEAR)


@pytest.mark.parametrize("name", sorted(BILINEAR))
def test_bilinear_defaults_match_jax(name):
    """The constructor's keyword defaults are the JAX fields' defaults."""
    from mvuld_tpu_torch.models.bilinear_fusion import BILINEAR_FUSIONS
    want = {f.name: f.default for f in dataclasses.fields(JAX_BILINEAR.get(name))
            if f.name not in ("parent", "name")}
    cls = BILINEAR_FUSIONS.get(name)
    got = {}
    for klass in reversed(cls.__mro__):
        if "__init__" in vars(klass) and klass.__module__.startswith(
                "mvuld_tpu_torch"):
            for p in inspect.signature(klass.__init__).parameters.values():
                if p.default is not inspect.Parameter.empty:
                    got[p.name] = p.default
    assert got == want


@pytest.mark.parametrize("name", sorted(BILINEAR))
def test_bilinear_matches_jax(name):
    """Output, and the gradients of the inputs and of every parameter for a
    seeded cotangent."""
    from mvuld_tpu_torch.models.bilinear_fusion import build_bilinear_fusion
    kw = BILINEAR[name]
    rng = np.random.RandomState(11)
    if name == "relational_network":
        xs = [rng.randn(3, 5, 12).astype(np.float32)]
        pm = build_bilinear_fusion(name, input_dim=12, **kw)
    else:
        xs = [rng.randn(3, 12).astype(np.float32),
              rng.randn(3, 10).astype(np.float32)]
        pm = build_bilinear_fusion(name, **kw)
    jm = JAX_BILINEAR.build(name, **kw)
    jin = [jnp.asarray(x) for x in xs]
    arg = (lambda a: a[0]) if name == "relational_network" else list
    flat = _random_variables(jm, (arg(jin),), {}, seed=12)
    cot = rng.randn(3, 8).astype(np.float32)

    out, vjp = jax.vjp(lambda p, *x: jm.apply({"params": p}, arg(x)),
                       _unflatten(flat)["params"], *jin)
    jgrads, *jdx = vjp(jnp.asarray(cot))

    jax_variables_to_torch(flat, pm)
    tin = [torch.as_tensor(x).requires_grad_() for x in xs]
    y = pm(arg(tin))
    names, params = zip(*pm.named_parameters())
    grads = torch.autograd.grad((y * torch.as_tensor(cot)).sum(),
                                [*tin, *params])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), **TOL)
    for g, w in zip(grads, jdx):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    ref = build_bilinear_fusion(name, **({"input_dim": 12} if len(xs) == 1
                                         else {}), **kw)
    jax_variables_to_torch({"params/" + k: np.asarray(a) for k, a in
                            flatten_variables(jgrads).items()}, ref)
    want = dict(ref.named_parameters())
    for n, g in zip(names, grads[len(xs):]):
        np.testing.assert_allclose(g.numpy(), want[n].detach().numpy(),
                                   **TOL, err_msg=n)


# ------------------------------------------------------------ the CLI

CLI_OPTS = ["DATA.MAX_NODES", "8", "MODEL.MULTI.HIDDEN", "64",
            "MODEL.MULTI.NUM_RS_GCN", "1", "MODEL.MULTI.NUM_HIDDEN_FC", "1",
            "MODEL.MULTI.IMG_DIM", str(I), "MODEL.MULTI.TEXT_DIM", str(D),
            "PARALLEL.DTYPE", "float32", "TRAIN.WARMUP_EPOCHS", "1",
            "TRAIN.BASE_LR", "2e-3", "TRAIN.WARMUP_LR", "1e-4",
            "TRAIN.MIN_LR", "1e-4", "TRAIN.EARLY_STOP_PATIENCE", "20",
            "TRAIN.EPOCHS", "2", "PRINT_FREQ", "50"]
SUB = os.path.join("swinv2_base_patch4_window24to28", "default")
ARCH = "multi_defect_allnode"


def _write_cache(path):
    """train/val/test ``.npz`` caches of seeded rows in the precompute
    layout (uint8 edge bitmasks with self-loops, node types on valid
    nodes)."""
    rng = np.random.RandomState(21)
    os.makedirs(path)
    for part, n in (("train", 24), ("val", 8), ("test", 8)):
        node_emb, pos, adj, node_mask = _graph_inputs(rng, n, N, D)
        bits = (adj * (1 << rng.randint(0, 4, adj.shape))).astype(np.uint8)
        bits[:, np.arange(N), np.arange(N)] |= np.uint8(15)
        np.savez(os.path.join(path, f"{part}.npz"),
                 img_emb=rng.randn(n, I).astype(np.float32),
                 text_emb=rng.randn(n, D).astype(np.float32),
                 node_emb=node_emb, pos=pos, adj=bits, node_mask=node_mask,
                 ntype=(rng.randint(0, 32, (n, N)) * node_mask
                        ).astype(np.int32),
                 label=(np.arange(n) % 2).astype(np.int32))


def _losses(log_path):
    with open(log_path) as f:
        return [float(line.split(": loss ")[1].split()[0])
                for line in f if ": loss " in line]


def test_train_fusion_cli_non_production_key_matches_jax(tmp_path,
                                                         monkeypatch):
    from mvuld_tpu.config import get_config as jget
    from mvuld_tpu.train.train_fusion import main as jmain
    from mvuld_tpu_torch.models import convert, dropout
    from mvuld_tpu_torch.train.train_fusion import main as pmain

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(dropout, "apply_keep", lambda x, mask, rate: x)
    cache = str(tmp_path / "cache")
    _write_cache(cache)
    common = ["--cache-dir", cache, "--batch-size", "8", "--arch", ARCH]
    jout = str(tmp_path / "jax")
    jres = jmain([*common, "--output", jout, "--opts", *CLI_OPTS])

    jcfg = jget(SimpleNamespace(cfg=None, opts=CLI_OPTS, output="unused"))
    z = np.load(os.path.join(cache, "train.npz"))
    one = {k: jnp.asarray(z[k][:1]) for k in
           ("img_emb", "text_emb", "node_emb", "pos", "node_mask", "ntype")}
    init = JAX_FUSION.build(ARCH, jcfg).init(
        jax.random.PRNGKey(jcfg.SEED), **one,
        adj=jnp.asarray(z["adj"][:1] > 0), train=False)
    flat = flatten_variables(jax.device_get(init))
    monkeypatch.setattr(convert, "init_jax_like",
                        lambda model, gen: jax_variables_to_torch(flat,
                                                                  model))
    runs = {}
    for name, extra in (("host", []),
                        ("device", ["TRAIN.DEVICE_DATA", "True",
                                    "TRAIN.DEVICE_EVAL", "True"])):
        out = str(tmp_path / name)
        res = pmain([*common, "--output", out, "--device", "cpu", "--opts",
                     *CLI_OPTS, *extra])
        runs[name] = (res, _losses(os.path.join(out, SUB, "log_rank0.txt")))
    ref = _losses(os.path.join(jout, SUB, "log_rank0.txt"))
    res, mine = runs["host"]
    assert len(mine) == len(ref) == 2
    np.testing.assert_allclose(mine, ref, atol=5e-4)
    assert len(res["history"]) == len(jres["history"]) == 2
    np.testing.assert_allclose(res["history"][0]["acc"],
                               jres["history"][0]["acc"], atol=1e-6)
    dres, dlosses = runs["device"]
    assert dlosses == mine
    assert dres["history"] == res["history"]
    assert dres["test_metrics"] == res["test_metrics"]
