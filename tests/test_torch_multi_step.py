"""K optimizer steps per call (TRAIN.FUSED_STEPS) against the JAX package,
on the CPU, where ``make_multi_train_step`` is the plain loop of K
``train_step`` calls (the card records them as one CUDA graph:
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Counterparts of ``tests/test_multi_step.py`` — K steps equal K single
steps, ``fit`` with fused steps over a split that leaves a remainder
equals the unfused run, indexed steps equal direct batches — plus
FUSED_STEPS × ACCUMULATION_STEPS, the optimizer's device-side schedule
against the host schedule at every count, ``shard_superbatch`` on a
world-2 gloo group against JAX's ``P(None, "dp")`` placement, and a tiny
SwinV2 through ``train_swin.main --opts TRAIN.FUSED_STEPS 2`` against the
JAX CLI.

Tolerances: the port's K fused steps equal its K single steps exactly (the
same calls); against JAX's parameters 1e-5 absolute (fp32 AdamW at lr
1e-2 over a few steps, other summation orders); the device schedule equals
the host schedule rounded to fp32 exactly, and optax's fp32 schedule to
2e-5 relative; the superbatch blocks exactly; the SwinV2 CLI's printed
losses 5e-4, as the unfused CLI test holds them.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from jax_reference import no_persistent_compile_cache  # noqa: F401

K, B, D = 4, 8, 4
ATOL = 1e-5
JNAMES = ("Dense_1", "Dense_0")      # JToy's layers of Toy's fc0, fc1


class JToy(fnn.Module):
    """JAX's toy: ``Dense(2)`` is built first, so it is "Dense_0"."""

    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(2)(fnn.relu(fnn.Dense(8)(x)))


class Toy(nn.Module):
    """``JToy`` in torch, with the train step's ``(train, gen)``."""

    def __init__(self):
        super().__init__()
        self.fc0, self.fc1 = nn.Linear(D, 8), nn.Linear(8, 2)

    def forward(self, x, train=False, gen=None):
        return self.fc1(torch.relu(self.fc0(x)))


def toy_inputs(batch):
    return {"x": batch["x"]}


def _jax_setup(accumulation=1):
    from mvuld_tpu.config import default_config
    from mvuld_tpu.core.optim import build_optimizer

    cfg = default_config()
    cfg.TRAIN.ACCUMULATION_STEPS = accumulation
    variables = JToy().init(jax.random.PRNGKey(0), jnp.zeros((1, D)))
    tx = build_optimizer(cfg, lambda s: 1e-2)

    def apply_fn(vs, batch, rngs, train, mutable=None):
        return JToy().apply(vs, batch["x"])

    return cfg, variables, tx, apply_fn


def _port(variables, cfg, accumulation=1):
    """The torch toy on JAX's weights and its optimizer as the JAX
    ``build_optimizer`` configures optax (decay on the kernels)."""
    from mvuld_tpu_torch.core.optim import Optimizer

    model = Toy()
    p = variables["params"]
    with torch.no_grad():
        for name, fc in zip(JNAMES, (model.fc0, model.fc1)):
            fc.weight.copy_(torch.tensor(np.asarray(p[name]["kernel"]).T))
            fc.bias.copy_(torch.tensor(np.asarray(p[name]["bias"])))
    t = cfg.TRAIN
    opt = Optimizer(list(model.named_parameters()),
                    {n: n.endswith("weight") for n, _ in
                     model.named_parameters()}, lambda count: 1e-2,
                    betas=tuple(t.OPTIMIZER.BETAS), eps=t.OPTIMIZER.EPS,
                    weight_decay=t.WEIGHT_DECAY, clip=t.CLIP_GRAD,
                    accumulation_steps=accumulation)
    return model, opt


def _jax_params(state):
    p = state.params
    return [np.asarray(p[name][k]).T if k == "kernel"
            else np.asarray(p[name][k])
            for name in JNAMES for k in ("kernel", "bias")]


def _port_params(model):
    return [t.detach().numpy() for fc in (model.fc0, model.fc1)
            for t in (fc.weight, fc.bias)]


def _data(seed=0, k=K):
    rng = np.random.RandomState(seed)
    return (rng.randn(k, B, D).astype(np.float32),
            rng.randint(0, 2, (k, B)).astype(np.int32))


@pytest.mark.parametrize("k,accumulation", [(K, 1), (3, 2), (4, 2)],
                         ids=["k4", "k3_accum2", "k4_accum2"])
def test_multi_step_equals_sequential_steps(k, accumulation):
    """K fused steps (MultiSteps accumulation inside them where asked) equal
    K single steps of the port exactly and JAX's ``make_multi_train_step``
    to 1e-5; the metrics are stacked to [K]."""
    from mvuld_tpu.core.train_state import TrainState
    from mvuld_tpu.core.train_state import (make_multi_train_step as
                                            jmulti)
    from mvuld_tpu_torch.core.train_state import (make_multi_train_step,
                                                  train_step)

    cfg, variables, tx, apply_fn = _jax_setup(accumulation)
    xs, ys = _data(k=k)
    multi = jmulti(apply_fn, tx, num_steps=k, label_smoothing=0.0,
                   donate=False)
    state, jm = multi(TrainState.create(variables["params"], tx),
                      {"x": jnp.asarray(xs), "label": jnp.asarray(ys)},
                      jax.random.PRNGKey(3))

    single, sopt = _port(variables, cfg, accumulation)
    for i in range(k):
        train_step(single, sopt, {"x": torch.tensor(xs[i]),
                                  "label": torch.tensor(ys[i])}, None, 0.0,
                   toy_inputs)
    fused, fopt = _port(variables, cfg, accumulation)
    step = make_multi_train_step(fused, fopt, k, 0.0, toy_inputs)
    metrics = step({"x": xs, "label": ys}, None)

    assert set(metrics) == {"loss", "grad_norm", "acc"}
    assert all(v.shape == (k,) for v in metrics.values())
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               np.asarray(jm["loss"]), atol=ATOL)
    assert len(set(np.round(metrics["loss"].numpy(), 6).tolist())) > 1
    assert fopt.count == sopt.count == k // accumulation
    assert fopt.mini_step == sopt.mini_step == k % accumulation
    for a, b, j in zip(_port_params(fused), _port_params(single),
                       _jax_params(state)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, j, rtol=0, atol=ATOL)


def test_indexed_steps_match_direct_batches():
    """``indexed=True`` (TRAIN.DEVICE_DATA): index superbatches gather rows
    of the resident columns; the parameters equal the direct steps' and
    JAX's indexed multi-step's."""
    from mvuld_tpu.core.train_state import TrainState
    from mvuld_tpu.core.train_state import (make_multi_train_step as
                                            jmulti)
    from mvuld_tpu_torch.core.train_state import (make_multi_train_step,
                                                  train_step)

    cfg, variables, tx, apply_fn = _jax_setup()
    N = 64
    rs = np.random.RandomState(1)
    cols = {"x": rs.randn(N, D).astype(np.float32),
            "label": rs.randint(0, 2, N).astype(np.int32)}
    idx = rs.permutation(N)[:K * B].astype(np.int32).reshape(K, B)
    jdata = {k: jnp.asarray(v) for k, v in cols.items()}
    state, _ = jmulti(apply_fn, tx, num_steps=K, label_smoothing=0.0,
                      donate=False, indexed=True)(
        TrainState.create(variables["params"], tx),
        {"idx": jnp.asarray(idx)}, jax.random.PRNGKey(3), jdata)

    data = {k: torch.tensor(v) for k, v in cols.items()}
    direct, dopt = _port(variables, cfg)
    for i in range(K):
        train_step(direct, dopt, {k: v[torch.tensor(idx[i]).long()]
                                  for k, v in data.items()}, None, 0.0,
                   toy_inputs)
    model, opt = _port(variables, cfg)
    step = make_multi_train_step(model, opt, K, 0.0, toy_inputs,
                                 indexed=True)
    metrics = step({"idx": idx}, None, data)
    assert metrics["loss"].shape == (K,) and opt.count == K
    with pytest.raises(ValueError, match="indexed"):
        step({"idx": idx}, None)
    for a, b, j in zip(_port_params(model), _port_params(direct),
                       _jax_params(state)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, j, rtol=0, atol=ATOL)


def _fit_cfgs():
    from mvuld_tpu.config import default_config as jdefault
    from mvuld_tpu_torch.config import default_config
    out = []
    for cfg in (jdefault(), default_config()):
        cfg.DATA.BATCH_SIZE = B
        cfg.TRAIN.EPOCHS = 2
        cfg.TRAIN.WARMUP_EPOCHS = 0
        cfg.TRAIN.EARLY_STOP_PATIENCE = 10
        cfg.PRINT_FREQ = 1000
        out.append(cfg)
    return out


def test_fit_with_fused_steps_matches_unfused():
    """``fit`` with FUSED_STEPS 3 over 8 batches an epoch (two superbatches
    and a remainder of two single steps) equals the unfused run exactly
    (history and parameters) and JAX's fused ``fit`` to 1e-5."""
    from mvuld_tpu.core.train_state import TrainState, make_eval_step
    from mvuld_tpu.core.train_state import (make_multi_train_step as
                                            jmulti, make_train_step)
    from mvuld_tpu.data.loader import ArrayDataset as JArrayDataset
    from mvuld_tpu.train.harness import fit as jfit
    from mvuld_tpu_torch.core.train_state import make_multi_train_step
    from mvuld_tpu_torch.data.loader import ArrayDataset
    from mvuld_tpu_torch.train.harness import fit

    rng = np.random.RandomState(0)
    w = rng.randn(D)
    xs = rng.randn(64, D).astype(np.float32)
    ys = (xs @ w > 0).astype(np.int32)
    jcfg, pcfg = _fit_cfgs()
    _, variables, tx, apply_fn = _jax_setup()
    jres = jfit(cfg=jcfg, state=TrainState.create(variables["params"], tx),
                train_step=make_train_step(apply_fn, tx, 0.0, donate=False),
                eval_step=make_eval_step(apply_fn),
                train_ds=JArrayDataset({"x": xs, "label": ys}),
                val_ds=JArrayDataset({"x": xs, "label": ys}),
                save_best=False, fused_steps=3,
                multi_step=jmulti(apply_fn, tx, 3, 0.0, donate=False))

    runs = []
    for fused in (1, 3):
        model, opt = _port(variables, pcfg)
        ds = ArrayDataset({"x": xs, "label": ys})
        multi = (make_multi_train_step(model, opt, fused, 0.0, toy_inputs)
                 if fused > 1 else None)
        res = fit(cfg=pcfg, model=model, opt=opt, train_ds=ds, val_ds=ds,
                  device=torch.device("cpu"), label_smoothing=0.0,
                  inputs=toy_inputs, multi_step=multi, fused_steps=fused)
        runs.append((res, model, opt))
    (r1, m1, o1), (r3, m3, o3) = runs
    assert o1.count == o3.count == 16 == int(jres["state"].step)
    assert r1["history"] == r3["history"]
    for a, b, j in zip(_port_params(m3), _port_params(m1),
                       _jax_params(jres["state"])):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, j, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["cosine", "linear", "step"])
def test_device_schedule_equals_the_host_schedule(name):
    """The optimizer reads its rate from the fp32 table at the clamped
    device count: at every count across the warmup and decay boundaries
    (and past the total for cosine and linear, which stay at their end)
    it equals the host schedule rounded to fp32, and optax's schedule."""
    from mvuld_tpu.core import schedule as js
    from mvuld_tpu_torch.core import schedule as ps
    from mvuld_tpu_torch.core.optim import Optimizer

    kw = dict(decay_steps=7, decay_rate=0.5) if name == "step" else {}
    for warm in (0, 5):
        host = ps.SCHEDULERS[name](1e-3, 1e-5, 1e-6, warm, 40, **kw)
        ref = getattr(js, f"{name}_schedule")(1e-3, 1e-5, 1e-6, warm, 40,
                                              **kw)
        p = torch.zeros(3)
        opt = Optimizer([("w", p)], {"w": False}, host, name="sgd",
                        momentum=0.0, clip=None)
        last = 45 if name != "step" else 40
        for count in range(last + 1):
            p.zero_()
            opt.update([torch.ones(3)])
            got = -float(p[0])                   # 0 − lr · 1 in fp32
            assert got == float(np.float32(host(count))), (warm, count)
            np.testing.assert_allclose(got, float(ref(count)), rtol=2e-5,
                                       atol=1e-12)
        assert opt.count == last + 1


def test_shard_superbatch_world2():
    """A [K, B, ...] superbatch's batch axis split over two gloo ranks: each
    rank's block equals JAX's ``shard_superbatch`` shard on its device,
    and the step axis stays whole."""
    from mvuld_tpu.parallel.mesh import make_mesh as jmesh
    from mvuld_tpu.parallel.mesh import shard_superbatch as jshard
    from mvuld_tpu_torch.parallel.distributed import run_local_world

    import torch_parallel_workers as workers

    rs = np.random.RandomState(5)
    sb = {"x": rs.randn(3, 8, 2, 5).astype(np.float32),
          "label": rs.randint(0, 2, (3, 8)).astype(np.int32)}
    mesh = jmesh(2, 1, jax.devices()[:2])
    placed = jshard(mesh, sb)
    res = run_local_world(workers.superbatch_world2, 2, sb, timeout=240)
    for key, arr in placed.items():
        shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
        for rank, shard in enumerate(shards):
            np.testing.assert_array_equal(res[rank][key],
                                          np.asarray(shard.data))
            assert res[rank][key].shape[0] == 3


def test_train_swin_fused_steps_matches_jax(tmp_path, monkeypatch):
    """``train_swin.main --opts TRAIN.FUSED_STEPS 2`` on the tiny SwinV2
    (converted JAX weights, rates 0, mixup on) against the JAX CLI with the
    same option: the printed losses (a superbatch prints its last step)
    within 5e-4, the history's epochs and test metrics present."""
    from mvuld_tpu.models.swin_v2 import SwinTransformerV2 as JSwin
    from mvuld_tpu.models.swin_v2 import SwinV2Config as JCfg
    from mvuld_tpu.train.train_swin import main as jmain
    from mvuld_tpu_torch.models import convert
    from mvuld_tpu_torch.models.convert import (flatten_variables,
                                                jax_variables_to_torch)
    from mvuld_tpu_torch.train.train_swin import main as pmain
    from test_torch_swin_train import CLI_OPTS, _cfgs, _losses

    opts = CLI_OPTS + ["TRAIN.FUSED_STEPS", "2"]
    common = ["--synthetic", "60", "--batch-size", "8", "--cache-dir",
              str(tmp_path / "cache"), "--opts", *opts]
    jres = jmain(["--output", str(tmp_path / "jax"), *common])
    jcfg, _ = _cfgs(opts + ["DATA.BATCH_SIZE", "8"])
    size = jcfg.DATA.IMG_SIZE
    init = JSwin(JCfg.from_cfg(jcfg), scan_blocks=True).init(
        jax.random.PRNGKey(jcfg.SEED), jnp.zeros((2, size, size, 3)))
    flat = flatten_variables(jax.device_get(init))
    monkeypatch.setattr(convert, "init_jax_like",
                        lambda model, gen: jax_variables_to_torch(flat,
                                                                  model))
    res = pmain(["--output", str(tmp_path / "port"), "--device", "cpu",
                 *common])
    sub = os.path.join("swinv2_base_patch4_window24to28", "default")
    mine = _losses(os.path.join(str(tmp_path / "port"), sub,
                                "log_rank0.txt"))
    ref = _losses(os.path.join(str(tmp_path / "jax"), sub, "log_rank0.txt"))
    assert len(mine) == len(ref) >= 4
    np.testing.assert_allclose(mine, ref, atol=5e-4)
    assert len(res["history"]) == len(jres["history"]) == 2
    assert res.get("test_metrics") is not None
