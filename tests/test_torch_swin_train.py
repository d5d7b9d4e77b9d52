"""The port's SwinV2 fine-tune slice against the JAX package, on the CPU.

- ``models/swin_convert.py`` against ``swinv2_torch_to_flax`` +
  ``to_scan_layout`` and the JAX forward, on a tiny reference-layout
  checkpoint drawn from a numpy seed (buffers to drop included): a
  21841-class head mapped to 1000 classes, a 5-class head re-initialised
  for 2, and an absolute position embedding resampled from a 6×6 to the
  model's 8×8 grid. Logits at fp32 within 1e-4 (absolute and relative: the
  same formulas, other summation orders); the resampled embedding within
  1e-4 of cv2's INTER_CUBIC (the JAX converter's call; same cubic kernel,
  cv2 tabulates its weights); the re-initialised head exactly equal.
- The trainer CLI ``train_swin.main`` on the tiny ``--synthetic 60``
  config of ``tests/test_train_swin.py`` (mixup 0.8, fp32, plain layers),
  starting from JAX's initial variables, against JAX's ``train_swin.main``:
  both render the same corpus, draw the same augmentation, batch order and
  mixup targets from the same numpy seeds, so the losses logged every two
  steps agree within 5e-4 (logged to 4 decimals; fp32 drift over 10
  steps). ``--throughput`` on the CPU gives a positive rate.
- The kernel path's SwinV2 classifier (plain K1/K2/K5/K3 on the CPU) with
  stages checkpointed gives the gradients of the uncheckpointed one under
  both backward generations (1e-6), runs K1 once per block, and the v1
  and v2 gradients agree within 1e-5.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu_torch.models.convert import (flatten_variables,
                                            jax_variables_to_torch)
from jax_reference import no_persistent_compile_cache  # noqa: F401

TINY = ["DATA.IMG_SIZE", "32", "MODEL.SWINV2.EMBED_DIM", "16",
        "MODEL.SWINV2.DEPTHS", "[2,2]", "MODEL.SWINV2.NUM_HEADS", "[2,2]",
        "MODEL.SWINV2.WINDOW_SIZE", "4",
        "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", "[0,0]",
        "PARALLEL.DTYPE", "float32"]


def _cfgs(opts):
    from mvuld_tpu.config import get_config as jget
    from mvuld_tpu_torch.config import get_config as pget
    ns = SimpleNamespace(cfg=None, opts=opts, output="unused")
    return jget(ns), pget(ns)


def _reference_checkpoint(model, n_head, ape_grid=None, seed=0):
    """A reference-layout state dict for ``model``'s architecture with
    seeded values, an ``n_head``-class head and the reference's buffers."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("head."):
            continue
        shape = tuple(v.shape)
        if k == "absolute_pos_embed" and ape_grid:
            shape = (1, ape_grid * ape_grid, shape[-1])
        sd[k] = (0.1 * rng.randn(*shape)).astype(np.float32)
        if k.endswith("logit_scale"):
            sd[k] = np.log(10.0) + sd[k]
    blk = "layers.0.blocks.1.attn."
    sd[blk + "relative_position_index"] = np.zeros((16, 16), np.int64)
    sd[blk + "relative_coords_table"] = np.zeros((1, 7, 7, 2), np.float32)
    sd["layers.0.blocks.1.attn_mask"] = np.zeros((4, 16, 16), np.float32)
    feats = model.norm.weight.shape[0]
    sd["head.weight"] = (0.1 * rng.randn(n_head, feats)).astype(np.float32)
    sd["head.bias"] = (0.1 * rng.randn(n_head)).astype(np.float32)
    return sd


@pytest.mark.parametrize("n_head,classes,ape", [(21841, 1000, False),
                                                 (5, 2, True)],
                         ids=["map22kto1k", "reinit_head_ape6to8"])
def test_swin_convert_matches_jax(n_head, classes, ape):
    from mvuld_tpu.models.swin_convert import (swinv2_torch_to_flax,
                                               to_scan_layout)
    from mvuld_tpu.models.swin_v2 import SwinTransformerV2 as JSwin
    from mvuld_tpu.models.swin_v2 import SwinV2Config as JCfg
    from mvuld_tpu_torch.models.swin_convert import convert_swinv2_state_dict
    from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                SwinV2Config)

    opts = TINY + ["MODEL.NUM_CLASSES", str(classes),
                   "MODEL.SWINV2.APE", str(ape)]
    jcfg, pcfg = _cfgs(opts)
    jsc = JCfg.from_cfg(jcfg)
    pm = SwinTransformerV2(SwinV2Config.from_cfg(pcfg), num_classes=classes)
    sd = _reference_checkpoint(pm, n_head, ape_grid=6 if ape else None)
    params = to_scan_layout(swinv2_torch_to_flax(sd, jsc), jsc)
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    ref = JSwin(jsc, scan_blocks=True).apply({"params": params},
                                             jnp.asarray(x))
    conv = convert_swinv2_state_dict({k: torch.as_tensor(v)
                                      for k, v in sd.items()}, pm)
    if ape:
        np.testing.assert_allclose(conv["absolute_pos_embed"].numpy(),
                                   params["absolute_pos_embed"], atol=1e-4)
        # the JAX tree's embedding in place of the port's resampling, for
        # the forward comparison below
        conv["absolute_pos_embed"] = torch.as_tensor(
            np.asarray(params["absolute_pos_embed"]))
    np.testing.assert_array_equal(conv["head.weight"].numpy(),
                                  np.asarray(params["head"]["kernel"]).T)
    pm.load_state_dict(conv, strict=True)
    with torch.no_grad():
        out = pm(torch.as_tensor(x)).numpy()
    assert out.shape == (2, classes)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- trainer

CLI_OPTS = ["DATA.IMG_SIZE", "64", "MODEL.SWINV2.EMBED_DIM", "16",
            "MODEL.SWINV2.DEPTHS", "[1,1]", "MODEL.SWINV2.NUM_HEADS", "[2,2]",
            "MODEL.SWINV2.WINDOW_SIZE", "4",
            "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", "[0,0]",
            "MODEL.DROP_PATH_RATE", "0.0", "TRAIN.EPOCHS", "2",
            "TRAIN.WARMUP_EPOCHS", "1", "TRAIN.BASE_LR", "1e-2",
            "TRAIN.WARMUP_LR", "1e-3", "TRAIN.MIN_LR", "1e-3",
            "PARALLEL.DTYPE", "float32", "AUG.MIXUP", "0.8",
            "PRINT_FREQ", "2"]


def _losses(log_path):
    with open(log_path) as f:
        return [float(line.split(": loss ")[1].split()[0])
                for line in f if ": loss " in line]


def test_train_swin_cli_matches_jax_losses(tmp_path, monkeypatch):
    from mvuld_tpu.models.swin_v2 import SwinTransformerV2 as JSwin
    from mvuld_tpu.models.swin_v2 import SwinV2Config as JCfg
    from mvuld_tpu.train.train_swin import main as jmain
    from mvuld_tpu_torch.models import convert
    from mvuld_tpu_torch.train.train_swin import main as pmain

    common = ["--synthetic", "60", "--batch-size", "8", "--opts", *CLI_OPTS]
    jres = jmain(["--output", str(tmp_path / "jax"), *common])
    jcfg, _ = _cfgs(CLI_OPTS + ["DATA.BATCH_SIZE", "8"])
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
    assert np.isfinite(res["best_f1"])


def test_train_swin_throughput_on_the_cpu(tmp_path):
    from mvuld_tpu_torch.train.train_swin import main
    res = main(["--batch-size", "2", "--output", str(tmp_path),
                "--throughput", "--device", "cpu", "--opts", *TINY])
    assert res["throughput"] > 0


# ------------------------------------------------- kernel path, remat, v1

def test_swin_kernel_path_remat_and_both_backwards(monkeypatch):
    from mvuld_tpu_torch.core.train_state import cross_entropy
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                SwinV2Config)
    from mvuld_tpu_torch.ops import window_attention as wa

    _, pcfg = _cfgs(TINY + ["MODEL.DROP_PATH_RATE", "0.2"])
    sc = SwinV2Config.from_cfg(pcfg)
    calls = []
    k1 = wa.window_attention_flat
    monkeypatch.setattr(wa, "window_attention_flat",
                        lambda *a, **k: calls.append(1) or k1(*a, **k))
    x = torch.as_tensor(np.random.RandomState(2).randn(2, 32, 32, 3),
                        dtype=torch.float32)
    soft = torch.tensor([[0.3, 0.7], [0.9, 0.1]])

    def grads(model):
        logits = model(x, train=True, gen=torch.Generator().manual_seed(5))
        loss = cross_entropy(logits, None, 0.0, soft)
        return torch.autograd.grad(loss, list(model.parameters()))

    base = SwinTransformerV2(sc, use_pallas=True, use_pallas_mlp=True,
                             num_classes=2)
    init_jax_like(base, torch.Generator().manual_seed(0))
    remat = SwinTransformerV2(sc, use_pallas=True, use_pallas_mlp=True,
                              num_classes=2, remat_stages=(0, 1))
    remat.load_state_dict(base.state_dict())
    out = {}
    for gen in ("v1", "v2"):
        monkeypatch.setenv("MVULD_ATTN_BWD", gen)
        g0 = grads(base)
        n0 = len(calls)
        g1 = grads(remat)
        assert n0 % 4 == 0 and len(calls) == 2 * n0   # one K1 per block
        for a, b in zip(g1, g0):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
        out[gen] = g0
        calls.clear()
    for a, b in zip(out["v1"], out["v2"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
