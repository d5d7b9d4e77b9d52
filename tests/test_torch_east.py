"""The port's EAST detector, its trainer and loaders against the JAX
package, on the CPU, at 64² and batch 2-4.

- ``ocr/east.EAST`` on Flax-initialised variables (BatchNorm statistics
  drawn from a numpy seed) carried across by ``jax_variables_to_torch``:
  eval and train-mode score/geo within 1e-5 relative L2 (fp32, other
  summation orders; a train-mode BatchNorm over the /32 map's 8 values
  per channel amplifies rounding), the updated running statistics within
  1e-5 relative L2; ``east_loss`` / ``dice_loss`` within 1e-6, the no-positive
  case exactly 0; every gradient of the loss within 1e-4 relative L2 of
  ``jax.grad``, except the 20 convolution biases that feed a train-mode
  BatchNorm, whose gradient is exactly 0 (both sides' rounding noise stays
  below 1e-5 of the layer's weight gradient); ``init_jax_like`` gives
  Flax's initialisers.
- ``train_east.main --no-crop`` on the same rendered corpus from JAX's
  initial variables (``--lr 1e-6``, see the test): per-epoch losses within
  1e-5 of the port's own fp64 run and within 1e-4 of JAX's, or 3× JAX's
  own distance from the fp64 run; the learning-rate sequence is optax's
  ``piecewise_constant_schedule`` and the first Adam updates optax.adam's
  (1e-7).
- With the corpus cached, the trainer runs with jax, PIL, cv2, yaml and
  pandas blocked (the GPU machine's situation).
- ``load_east_detector`` on a port checkpoint root and on a JAX ``.npz``
  gives Flax's maps (1e-5 relative L2).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu_torch.models.convert import (flatten_variables,
                                            jax_variables_to_torch,
                                            torch_to_jax_names)
from jax_reference import no_persistent_compile_cache  # noqa: F401
from test_torch_models import _unflatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_TOL = 1e-5
GRAD_TOL = 1e-4


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def flax_east():
    """(Flax EAST, its variables with seeded BatchNorm statistics, a seeded
    input batch [2, 64, 64, 3] and its gt maps)."""
    from mvuld_tpu.ocr.east import EAST
    from mvuld_tpu_torch.ocr.gt import rasterize_gt
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    model = EAST()
    variables = jax.device_get(model.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)))
    flat = flatten_variables(variables)
    for k in flat:
        if k.startswith("batch_stats/"):
            flat[k] = (rng.uniform(0.5, 1.5, flat[k].shape) if k.endswith("var")
                       else 0.1 * rng.randn(*flat[k].shape)).astype(np.float32)
    gts = [rasterize_gt([np.array([[8, 10], [40, 10], [40, 22], [8, 22]],
                                  np.float32) + 4 * i,
                         np.array([[30, 40], [60, 44], [58, 56], [28, 52]],
                                  np.float32)], 64, 64) for i in range(2)]
    gt = {k: np.stack([g[j] for g in gts])
          for j, k in enumerate(("score", "geo", "ignored"))}
    return model, flat, x, gt


def _port(flat):
    from mvuld_tpu_torch.ocr.east import EAST
    m = EAST()
    jax_variables_to_torch(flat, m)
    return m


def test_east_eval_and_train_maps_and_batch_stats_match_flax(flax_east):
    from mvuld_tpu_torch.ocr.east import to_nchw
    model, flat, x, _ = flax_east
    v = _unflatten(flat)
    pm = _port(flat)
    s, g = model.apply(v, jnp.asarray(x), train=False)
    ps, pg = pm(to_nchw(x), train=False)
    assert ps.shape == (2, 1, 16, 16) and pg.shape == (2, 5, 16, 16)
    assert _rel_l2(_nhwc(ps), s) <= MAP_TOL
    assert _rel_l2(_nhwc(pg), g) <= MAP_TOL
    (s, g), mut = model.apply(v, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    ps, pg = pm(to_nchw(x), train=True)
    assert _rel_l2(_nhwc(ps), s) <= MAP_TOL
    assert _rel_l2(_nhwc(pg), g) <= MAP_TOL
    names = {j: t for t, j in torch_to_jax_names(pm).items()}
    sd = pm.state_dict()
    new = flatten_variables({"batch_stats": jax.device_get(
        mut["batch_stats"])})
    assert len(new) == 2 * (13 + 7)
    for k, want in new.items():
        assert _rel_l2(sd[names[k]].numpy(), want) <= MAP_TOL, k
        assert not np.allclose(want, flat[k])       # they did move


def test_east_loss_and_dice_match_jax(flax_east):
    from mvuld_tpu.ocr.east import dice_loss as jdice
    from mvuld_tpu.ocr.east import east_loss as jloss
    from mvuld_tpu_torch.ocr.east import dice_loss, east_loss, to_nchw
    _, _, _, gt = flax_east
    rng = np.random.RandomState(1)
    pred_s = rng.rand(2, 16, 16, 1).astype(np.float32)
    pred_g = np.concatenate([rng.rand(2, 16, 16, 4) * 30,
                             rng.uniform(-0.7, 0.7, (2, 16, 16, 1))],
                            -1).astype(np.float32)
    ign = (rng.rand(2, 16, 16, 1) < 0.1).astype(np.float32)
    t = lambda a: to_nchw(a)  # noqa: E731
    want = float(jloss(gt["score"], pred_s, gt["geo"], pred_g, ign))
    got = float(east_loss(t(gt["score"]), t(pred_s), t(gt["geo"]),
                          t(pred_g), t(ign)))
    assert want > 0 and abs(got - want) <= 1e-6 * abs(want)
    assert abs(float(dice_loss(t(gt["score"]), t(pred_s)))
               - float(jdice(gt["score"], pred_s))) <= 1e-6
    z = np.zeros_like(gt["score"])
    assert float(east_loss(t(z), t(pred_s), t(gt["geo"]), t(pred_g),
                           t(ign))) == 0.0
    assert float(jloss(z, pred_s, gt["geo"], pred_g, ign)) == 0.0


def test_east_gradients_match_jax_grad(flax_east):
    from mvuld_tpu.ocr.east import east_loss as jloss
    from mvuld_tpu_torch.ocr.east import east_loss, to_nchw
    model, flat, x, gt = flax_east
    v = _unflatten(flat)

    def loss_fn(params):
        (s, g), _ = model.apply({"params": params,
                                 "batch_stats": v["batch_stats"]},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        return jloss(gt["score"], s, gt["geo"], g, gt["ignored"])

    want_loss, grads = jax.value_and_grad(loss_fn)(v["params"])
    want = flatten_variables({"params": jax.device_get(grads)})
    pm = _port(flat)
    s, g = pm(to_nchw(x), train=True)
    loss = east_loss(to_nchw(gt["score"]), s, to_nchw(gt["geo"]), g,
                     to_nchw(gt["ignored"]))
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        1e-5 * float(want_loss)
    names = torch_to_jax_names(pm)
    params = dict(pm.named_parameters())
    got = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert len(got) == len(want) == 4 * 13 + 4 * 7 + 6
    cancelling = 0
    for name, gr in got.items():
        ref = _to_torch_layout(want[names[name]])
        if name.endswith(".bias") and ".conv_" in name:
            # a convolution's bias before a train-mode BatchNorm: its
            # gradient is exactly 0 (the batch mean takes the bias out), so
            # both sides are rounding noise; both stay below 1e-5 of the
            # layer's weight gradient
            w = float(got[name[:-4] + "weight"].abs().max())
            assert float(gr.abs().max()) <= 1e-5 * w, name
            assert float(np.abs(ref).max()) <= 1e-5 * w, name
            cancelling += 1
            continue
        assert _rel_l2(gr.numpy().reshape(-1), ref.reshape(-1)) <= GRAD_TOL, \
            name
    assert cancelling == 13 + 7


def _to_torch_layout(a):
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def test_init_jax_like_gives_flax_initialisers():
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.ocr.east import EAST
    m = EAST()
    init_jax_like(m, torch.Generator().manual_seed(0))
    for name, mod in m.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            fan_in = mod.weight[0].numel()
            if mod.weight.numel() >= 1000:      # a std estimate within 5 %
                std = float(mod.weight.detach().std())
                assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05, name
            assert float(mod.weight.detach().abs().max()) <= 2.0 / np.sqrt(
                fan_in) / 0.8796256610342398 + 1e-6
            assert not mod.bias.any()
        if isinstance(mod, torch.nn.BatchNorm2d):
            assert (mod.weight == 1).all() and not mod.bias.any()
            assert not mod.running_mean.any()
            assert (mod.running_var == 1).all()


# -------------------------------------------------------------- trainer

def test_lr_schedule_and_adam_match_optax():
    import optax

    from mvuld_tpu_torch.train.train_east import build_optimizer, lr_schedule
    for steps in (1, 6, 7, 20):
        want = optax.piecewise_constant_schedule(1e-3, {steps // 2: 0.1})
        assert [lr_schedule(1e-3, steps)(i) for i in range(steps + 2)] == \
            [float(want(i)) for i in range(steps + 2)]
    lin = torch.nn.Linear(5, 3)
    p0 = {n: p.detach().numpy().copy() for n, p in lin.named_parameters()}
    opt = build_optimizer(lin, 1e-3, 4)
    tx = optax.adam(optax.piecewise_constant_schedule(1e-3, {2: 0.1}))
    params = {n: jnp.asarray(v) for n, v in p0.items()}
    state = tx.init(params)
    rng = np.random.RandomState(2)
    for _ in range(4):
        g = {n: rng.randn(*v.shape).astype(np.float32) * 10
             for n, v in p0.items()}
        upd, state = tx.update({n: jnp.asarray(a) for n, a in g.items()},
                               state, params)
        params = optax.apply_updates(params, upd)
        opt.update([torch.as_tensor(g[n]) for n, _ in
                    lin.named_parameters()])
    for n, p in lin.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]),
                                   rtol=0, atol=1e-7)


EAST_CLI = ["--synthetic", "12", "--img-size", "64", "--epochs", "2",
            "--batch-size", "4", "--no-crop"]


def test_train_east_cli_matches_jax(tmp_path, monkeypatch):
    """Per-epoch losses of the two CLIs from the same corpus and initial
    variables, fp32 held against fp64 as chip_smoke.py holds the zoo: the
    port's fp32 run within 1e-5 of its own fp64 run, and within 1e-4 of
    JAX's or within 3× JAX's own distance from that fp64 run.

    At ``--lr 1e-6``: Adam's first steps move every weight by about the
    learning rate whatever its gradient's size, so a weight whose gradient
    lies below a run's rounding error moves either way. JAX's fp32 loss on
    the CPU lies further from fp64 than the port's, and at the default
    1e-3 such moves part the two runs' losses well beyond 1e-4 within a
    few steps; at 1e-6 they are 1000× smaller.
    The step itself is held at the default rate by the gradient test and
    by ``test_lr_schedule_and_adam_match_optax``."""
    from mvuld_tpu.ocr.east import EAST as JEAST
    from mvuld_tpu.train.train_east import main as jmain
    from mvuld_tpu_torch.core.checkpoint import load_checkpoint
    from mvuld_tpu_torch.models import convert
    from mvuld_tpu_torch.ocr import east as peast
    from mvuld_tpu_torch.train.train_east import corpus_path
    from mvuld_tpu_torch.train.train_east import main as pmain

    cli = [*EAST_CLI, "--lr", "1e-6"]
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jres = jmain([*cli, "--out-dir", jout])
    init = jax.device_get(JEAST().init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 64, 64, 3))))
    flat = flatten_variables(init)
    monkeypatch.setattr(convert, "init_jax_like",
                        lambda model, gen: jax_variables_to_torch(flat,
                                                                  model))
    res = pmain([*cli, "--out-dir", pout, "--device", "cpu"])

    class EAST64(peast.EAST):
        def __init__(self):
            super().__init__()
            self.double()

        def forward(self, x, train=False):
            return super().forward(x.double(), train)

    monkeypatch.setattr(peast, "EAST", EAST64)
    ref = pmain([*cli, "--out-dir", str(tmp_path / "port64"),
                 "--device", "cpu"])["losses"]
    monkeypatch.undo()
    # the port's renderer built the same corpus
    with np.load(corpus_path(os.path.join(pout, "corpus"), 12, 64, 0)) as a, \
            np.load(corpus_path(os.path.join(jout, "corpus"), 12, 64, 0)) as b:
        for k in ("images", "quads", "nquads"):
            np.testing.assert_array_equal(a[k], b[k])
    mine, want = np.asarray(res["losses"]), np.asarray(jres["losses"])
    assert len(mine) == len(want) == len(ref) == 2
    np.testing.assert_allclose(mine, ref, rtol=1e-5)
    own = 3 * np.abs(want - np.asarray(ref))
    assert (np.abs(mine - want) <= np.maximum(1e-4 * want, own)).all(), (
        mine, want, ref)
    assert set(res) == set(jres)
    ckpt = load_checkpoint(os.path.join(pout, "checkpoints", "ckpt_epoch_2"))
    assert set(ckpt["params"]) == set(res["model"].state_dict())
    # eval-only reloads it and runs no training
    only = pmain([*cli, "--out-dir", pout, "--device", "cpu",
                  "--eval-only", pout, "--eval-synthetic", "3"])
    assert only["losses"] == [] and 0.0 <= only["eval"]["hmean"] <= 1.0


def test_train_east_runs_without_jax_pil_or_cv2(tmp_path):
    """A cached corpus, ``--no-crop`` at the canvas size: no host extras."""
    from mvuld_tpu_torch.train.train_east import (corpus_path,
                                                  synthetic_canvases)
    out = str(tmp_path / "run")
    path = corpus_path(os.path.join(out, "corpus"), 8, 64, 0)
    os.makedirs(os.path.dirname(path))
    images, quads, nquads = synthetic_canvases(8, 64, seed=0)
    assert (nquads >= 1).all() and images.min() == 0
    np.savez(path, images=images, quads=quads, nquads=nquads)
    code = f"""
import json, sys
for name in ("jax", "jaxlib", "flax", "orbax", "PIL", "cv2", "yaml",
             "pandas", "tokenizers", "matplotlib"):
    sys.modules[name] = None
from mvuld_tpu_torch.train.train_east import main
res = main(["--synthetic", "8", "--img-size", "64", "--epochs", "2",
            "--batch-size", "4", "--no-crop", "--out-dir", {out!r},
            "--device", "cpu"])
print(json.dumps(res["losses"]))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    losses = [float(v) for v in r.stdout.strip().splitlines()[-1]
              .strip("[]").split(",")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert os.path.exists(os.path.join(out, "checkpoints", "ckpt_epoch_2"))


# -------------------------------------------------------------- loaders

def test_load_east_detector_port_checkpoint_and_jax_npz(flax_east, tmp_path):
    from mvuld_tpu_torch.core.checkpoint import save_checkpoint
    from mvuld_tpu_torch.ocr.detect import load_east_detector
    model, flat, x, _ = flax_east
    s, g = model.apply(_unflatten(flat), jnp.asarray(x[:1]), train=False)
    run = str(tmp_path / "east")
    save_checkpoint(run, 1, {"params": {k: torch.zeros_like(v) for k, v in
                                        _port(flat).state_dict().items()}})
    save_checkpoint(run, 3, {"params": _port(flat).state_dict()})
    npz = str(tmp_path / "east.npz")
    np.savez(npz, **flat)
    for path in (run, os.path.join(run, "checkpoints", "ckpt_epoch_3"), npz):
        apply_fn, params = load_east_detector(path, device="cpu")
        assert not params.training
        ps, pg = apply_fn(params, x[:1])
        assert isinstance(ps, np.ndarray) and ps.shape == (1, 16, 16, 1)
        assert _rel_l2(ps, s) <= MAP_TOL and _rel_l2(pg, g) <= MAP_TOL
    os.makedirs(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="ckpt_epoch_"):
        load_east_detector(str(tmp_path / "empty"), device="cpu")
