"""Swin-MoE as upstream configures it (``models/moe.py``: batch-prioritized
routing, the load-importance loss, MOE_DROP, MLP_FC2_BIAS) against the
benchmark's plain reference (``benchmark/reference/swin_moe.py``), on the
CPU at narrow widths: embed 32, depths 2-2-2, window 4, 64² images, 4
experts in blocks 1 of stage 1 and 0-1 of stage 3, fp32, both sides
loaded from one seeded weight table.

- Eval logits and aux within 1e-5, every layer's expert choice and
  keep-mask equal, with and without BPR and under either aux loss.
- A layer whose capacity overflows: BPR's kept set is the priority
  order's, the reference's, and not token order's.
- One training step with gate noise, MOE_DROP and DropPath drawn from one
  generator: loss within 1e-5 and every gradient within relative L2 1e-4
  (the reference with and without its per-block checkpointing).
- MLP_FC2_BIAS False leaves out fc2's bias in the experts and the dense
  MLPs; ``expert_parallel`` refuses BPR.
- The routing counters equal the reference's counts, once per forward
  under activation checkpointing (either checkpoint mode).
- ``build_swin_training`` with MODEL.TYPE swin_moe and TRAIN.FUSED_STEPS
  2 trains through ``fit`` (K steps per call and single steps, the aux
  loss in both).
"""

import types

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from benchmark.lib import weights
from benchmark.reference import follow_moe
from benchmark.reference import swin_moe as ref_moe

IMG, B = 64, 3
SWIN = {"img": IMG, "patch": 4, "chans": 3, "embed": 32, "depths": [2, 2, 2],
        "heads": [2, 4, 4], "window": 4, "mlp_ratio": 4.0,
        "drop_path_rate": 0.0}
BLOCKS = [[1], [-1], [0, 1]]
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4          # relative L2, fp32


def _moe(bpr=True, gshard=False, fc2_bias=False, noise=1.0, drop=0.0,
         cf=1.25):
    return {"blocks": BLOCKS, "experts": 4, "top_k": 1,
            "capacity_factor": cf, "gate_noise": noise, "aux_weight": 0.01,
            "drop": drop, "bpr": bpr, "gshard_loss": gshard,
            "fc2_bias": fc2_bias}


def _opts(moe, drop_path=0.0):
    return ["MODEL.TYPE", "swin_moe", "DATA.IMG_SIZE", IMG,
            "MODEL.SWIN_MOE.EMBED_DIM", SWIN["embed"],
            "MODEL.SWIN_MOE.DEPTHS", SWIN["depths"],
            "MODEL.SWIN_MOE.NUM_HEADS", SWIN["heads"],
            "MODEL.SWIN_MOE.WINDOW_SIZE", SWIN["window"],
            "MODEL.SWIN_MOE.MOE_BLOCKS", BLOCKS,
            "MODEL.SWIN_MOE.NUM_LOCAL_EXPERTS", moe["experts"],
            "MODEL.SWIN_MOE.CAPACITY_FACTOR", moe["capacity_factor"],
            "MODEL.SWIN_MOE.USE_BPR", moe["bpr"],
            "MODEL.SWIN_MOE.IS_GSHARD_LOSS", moe["gshard_loss"],
            "MODEL.SWIN_MOE.GATE_NOISE", moe["gate_noise"],
            "MODEL.SWIN_MOE.MOE_DROP", moe["drop"],
            "MODEL.SWIN_MOE.MLP_FC2_BIAS", moe["fc2_bias"],
            "MODEL.SWIN_MOE.AUX_LOSS_WEIGHT", moe["aux_weight"],
            "MODEL.DROP_PATH_RATE", drop_path, "MODEL.NUM_CLASSES", 2,
            "PARALLEL.DTYPE", "float32"]


def _cfg(opts):
    from mvuld_tpu_torch.config import get_config
    return get_config(types.SimpleNamespace(cfg=None, opts=opts,
                                            output="unused"))


def _pair(moe, drop_path=0.0, seed=3):
    """(the port's build_model, the reference), one weight table."""
    from mvuld_tpu_torch.models.swin_variants import build_model
    port = build_model(_cfg(_opts(moe, drop_path)))
    ref = ref_moe.SwinMoE({**SWIN, "drop_path_rate": drop_path}, moe, 2)
    table = follow_moe.weight_table(
        weights.spec_of(port.named_parameters()), seed, "cpu")
    weights.load(port, table)
    weights.load(ref, table)
    return port, ref


def _images(seed=1):
    rs = np.random.RandomState(seed)
    return (torch.as_tensor(rs.randn(B, IMG, IMG, 3).astype(np.float32)),
            torch.as_tensor(rs.randint(0, 2, B)).long())


def _port_routes(model):
    return [(m.routing[0][0], m.routing[1][0]) for m in model.moe_layers()]


def _assert_routes_equal(port, routes):
    got = _port_routes(port)
    assert len(got) == len(routes) == 3
    for (e, k), (re, rk, _) in zip(got, routes):
        assert torch.equal(e, re) and torch.equal(k, rk)


@pytest.mark.parametrize("bpr", [True, False], ids=["bpr", "token_order"])
@pytest.mark.parametrize("gshard", [False, True],
                         ids=["load_importance", "gshard"])
def test_eval_forward_matches_reference(bpr, gshard):
    port, ref = _pair(_moe(bpr, gshard, cf=0.5))
    x, _ = _images()
    routes = []
    with torch.no_grad():
        logits, aux = port(x)
        want, want_aux = ref(x, routes=routes)
    torch.testing.assert_close(logits, want, **FWD_TOL)
    torch.testing.assert_close(aux, want_aux, **FWD_TOL)
    _assert_routes_equal(port, routes)
    assert any(not bool(k.all()) for _, k in _port_routes(port))


def test_bpr_keeps_the_priority_order_under_overflow():
    """At capacity 8 for 64 tokens over 4 experts: the kept tokens of
    each expert are its C most confident (BPR), the reference's too, and
    another set than the first C in token order."""
    from mvuld_tpu_torch.models.moe import MoEFFN
    torch.manual_seed(0)
    D, T, E = 16, 64, 4
    x = torch.randn(T, D)
    kept = {}
    for bpr in (True, False):
        m = MoEFFN(D, 32, D, E, 1, 0.5, 1.0, 0.01, 0.0, bpr=bpr,
                   gshard_loss=False, fc2_bias=False)
        r = ref_moe._MoE(D, 32, E, _moe(bpr, cf=0.5))
        table = follow_moe.weight_table(
            weights.spec_of((f"b.mlp.{k}", p) for k, p in
                            m.named_parameters()), 5, "cpu")
        for mod in (m, r):
            with torch.no_grad():
                for k, p in mod.named_parameters():
                    p.copy_(table[f"b.mlp.{k}"])
        with torch.no_grad():
            y, aux = m(x)
            routes = []
            ry, raux = r(x[None], (None, None), routes)
        torch.testing.assert_close(y, ry[0], **FWD_TOL)
        torch.testing.assert_close(aux, raux, **FWD_TOL)
        e, keep = m.routing[0][0], m.routing[1][0]
        assert torch.equal(e, routes[0][0]) and torch.equal(keep, routes[0][1])
        assert int(keep.sum()) < T                       # it overflows
        kept[bpr] = keep
        if bpr:
            g = torch.softmax(x @ m.gate, -1).max(-1).values
            for j in range(E):
                mine = (e == j).nonzero()[:, 0]
                top = mine[torch.argsort(-g[mine], stable=True)[:8]]
                assert set(top.tolist()) == set(
                    mine[keep[mine]].tolist())
    assert not torch.equal(kept[True], kept[False])


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_gradients_match_reference(remat):
    """Gate noise 1.0, MOE_DROP 0.3 and DropPath 0.2 from one generator
    each side, seeded alike: the step's loss (CE with smoothing + aux) and
    every gradient."""
    from mvuld_tpu_torch.core.train_state import cross_entropy
    moe = _moe(drop=0.3, cf=0.75)
    port, ref = _pair(moe, drop_path=0.2)
    x, y = _images()
    logits, aux = port(x, train=True, gen=torch.Generator().manual_seed(7))
    loss = cross_entropy(logits, y, 0.1) + aux
    names, ps = zip(*port.named_parameters())
    got = torch.autograd.grad(loss, ps)
    draws = ref_moe.draw_masks(ref, B, torch.Generator().manual_seed(7),
                               "cpu")
    routes = [] if not remat else None
    rl, raux = ref(x, draws, routes=routes, remat=remat)
    from benchmark.reference.steps import cross_entropy as ref_ce
    rloss = ref_ce(rl, y, 0.1) + raux
    rloss.backward()
    torch.testing.assert_close(loss.detach(), rloss.detach(), **FWD_TOL)
    if routes is not None:
        _assert_routes_equal(port, routes)
    want = dict(ref.named_parameters())
    assert set(names) == set(want)
    for name, g in zip(names, got):
        w = want[name].grad.double()
        err = float((g.double() - w).norm() / w.norm().clamp_min(1e-30))
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("fc2_bias", [False, True], ids=["no_bias", "bias"])
def test_fc2_bias_follows_the_config(fc2_bias):
    from mvuld_tpu_torch.models.swin_variants import build_model
    names = [k for k, _ in build_model(_cfg(_opts(_moe(
        fc2_bias=fc2_bias)))).named_parameters()]
    experts = [k for k in names if k.endswith("mlp.b2")]
    dense = [k for k in names if k.endswith("mlp.fc2.bias")]
    assert (len(experts), len(dense)) == ((3, 3) if fc2_bias else (0, 0))
    assert len([k for k in names if k.endswith("mlp.w2")]) == 3


def test_expert_parallel_refuses_bpr():
    from mvuld_tpu_torch.models.moe import MoEFFN, expert_parallel
    with pytest.raises(NotImplementedError, match="batch-prioritized"):
        expert_parallel(MoEFFN(8, 16, 8, 4, bpr=True), None)
    m = MoEFFN(8, 16, 8, 4, bpr=True)
    m.ep = object()
    with pytest.raises(NotImplementedError, match="batch-prioritized"):
        m(torch.zeros(4, 8))
    with pytest.raises(ValueError, match="gate_noise"):
        MoEFFN(8, 16, 8, 4, gate_noise=0.0, gshard_loss=False)


@pytest.mark.parametrize("reentrant", [False, True],
                         ids=["non_reentrant", "reentrant"])
def test_counters_count_each_forward_once_under_checkpointing(reentrant):
    from mvuld_tpu_torch.models.moe import (reset_routing_counters,
                                            routing_counters)
    port, ref = _pair(_moe(cf=0.5))
    x, _ = _images()
    routes = []
    with torch.no_grad():
        ref(x, routes=routes)
    want = ref_moe.routing_counts(routes)
    assert 0 < want["kept"] < min(want["routed"], want["slots"])
    reset_routing_counters(port)
    logits, aux = torch.utils.checkpoint.checkpoint(
        port, x.requires_grad_(), use_reentrant=reentrant)
    assert routing_counters(port) == want          # the first run
    (logits.sum() + aux).backward()                # the recomputation
    assert routing_counters(port) == want
    port(x)
    assert routing_counters(port) == {k: 2 * v for k, v in want.items()}
    reset_routing_counters(port)
    assert routing_counters(port) == {"routed": 0, "kept": 0, "slots": 0}


def test_train_swin_fits_swin_moe_with_fused_steps():
    """``build_swin_training`` (MODEL.TYPE swin_moe, TRAIN.FUSED_STEPS 2):
    its step's loss is CE + the aux loss; ``fit`` over 5 batches (two
    calls of 2 steps, one single step) counts one forward per step."""
    from mvuld_tpu_torch.core.train_state import (cross_entropy,
                                                  image_inputs)
    from mvuld_tpu_torch.data.loader import ArrayDataset
    from mvuld_tpu_torch.models.moe import (reset_routing_counters,
                                            routing_counters)
    from mvuld_tpu_torch.train.harness import fit
    from mvuld_tpu_torch.train.train_swin import build_swin_training

    cfg = _cfg(_opts(_moe(drop=0.1), drop_path=0.1) + [
        "TRAIN.FUSED_STEPS", 2, "DATA.BATCH_SIZE", 2, "TRAIN.EPOCHS", 1,
        "TRAIN.WARMUP_EPOCHS", 0, "PRINT_FREQ", 1000, "SEED", 0])
    run = build_swin_training(cfg, torch.device("cpu"), steps_per_epoch=5)
    assert run.aux_loss and len(run.model.moe_layers()) == 3
    rs = np.random.RandomState(0)
    ds = ArrayDataset({"image": rs.randn(10, IMG, IMG, 3).astype(np.float32),
                       "label": rs.randint(0, 2, 10).astype(np.int32)})
    x = torch.as_tensor(ds.columns["image"][:2])
    batch = {"image": x, "label": torch.zeros(2).long()}
    logits, aux = run.model(x, train=True,
                            gen=torch.Generator().manual_seed(0))
    want = cross_entropy(logits, batch["label"], run.label_smoothing) + aux
    out = run.step(batch, torch.Generator().manual_seed(0))
    torch.testing.assert_close(out["loss"], want.detach(), atol=0, rtol=0)
    assert run.opt.count == 1
    reset_routing_counters(run.model)
    res = fit(cfg=cfg, model=run.model, opt=run.opt, train_ds=ds, val_ds=ds,
              device=torch.device("cpu"), label_smoothing=0.1,
              inputs=image_inputs, multi_step=run.multi_step(2),
              fused_steps=2, aux_loss=run.aux_loss)
    assert run.opt.count == 6 and len(res["history"]) == 1
    # 5 training forwards of 2 images and the validation's 10 images
    per_image = 16 * 16 + 2 * 4 * 4
    assert routing_counters(run.model)["routed"] == 20 * per_image
