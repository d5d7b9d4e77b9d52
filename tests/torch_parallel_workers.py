"""Rank functions of ``tests/test_torch_parallel.py``'s spawned worlds.

Each runs inside ``mvuld_tpu_torch.parallel.distributed.run_local_world``
(gloo, CPU) and returns numpy results for the test process to hold against
the JAX package and the one-rank port. Torch only: the spawned processes
import no JAX.
"""

import copy

import numpy as np
import torch
import torch.distributed as dist

from mvuld_tpu_torch.parallel import collectives as cc


def _np(t):
    return t.detach().cpu().numpy()


def _optimizer(model):
    from mvuld_tpu_torch.core.optim import Optimizer, decay_mask
    return Optimizer(list(model.named_parameters()), decay_mask(model),
                     lambda count: 1e-3, weight_decay=0.05, clip=5.0)


def _step(model, batch, inputs, mesh=None, tp_norm=None):
    """One train step; returns (metrics, the gradients the optimizer got,
    the state dict after the step)."""
    from mvuld_tpu_torch.core.train_state import train_step
    opt = _optimizer(model)
    if tp_norm is not None:
        opt.norm = tp_norm
    got = {}
    update = opt.update

    def capture(grads):
        got["grads"] = [g.clone() for g in grads]
        update(grads)

    opt.update = capture
    metrics = train_step(model, opt, batch, None, 0.1, inputs, mesh=mesh)
    names = [n for n, _ in model.named_parameters()]
    return ({k: float(v.detach()) for k, v in metrics.items()},
            dict(zip(names, [_np(g) for g in got["grads"]])),
            {k: _np(v) for k, v in model.state_dict().items()})


def _max_diffs(a, b):
    return {k: float(np.abs(a[k] - b[k]).max()) if a[k].size else 0.0
            for k in a}


# ------------------------------------------------------------- world 4

def world4(rank, world, sp_refs, swin_ref, moe_cases, tp_case):
    from mvuld_tpu_torch.parallel.distributed import (is_primary,
                                                      process_count,
                                                      process_index,
                                                      shard_manifest)
    from mvuld_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    out = {}
    # mesh shapes (test_parallel.py::test_mesh_8_devices at world 4)
    m41 = make_mesh(dp=4)
    m22 = make_mesh(dp=2, mp=2)
    out["mesh"] = (m41.ranks.shape, m22.ranks.shape, m22.dp_rank,
                   m22.mp_rank, cc.size(m22.dp_group), cc.size(m22.mp_group))
    for dp, mp in ((8, 2), (1, 2)):
        try:
            make_mesh(dp=dp, mp=mp)
            out[f"mesh_{dp}x{mp}"] = "built"
        except ValueError as e:
            out[f"mesh_{dp}x{mp}"] = str(e)
    out["helpers"] = (process_index(), is_primary(), process_count(),
                      shard_manifest(list(range(7))))

    out["sp"] = {shift: _sp_attention(*ins, shift)
                 for shift, ins in sp_refs.items()}
    out["sp_indivisible"] = _sp_indivisible(*sp_refs[0])
    out["sp_model"] = _sp_model(*swin_ref)
    out["moe"] = [_moe(rank, world, *case) for case in moe_cases]
    out["tp"] = _tp_step(m22, *tp_case)
    return out


def _sp_attention(qkv, bias, scale, shift):
    """Loss Σ out·cos(out) through the sharded attention over the world
    group: the output and the three gradients."""
    from mvuld_tpu_torch.ops.window_attention import (
        window_attention_flat_sharded)
    q, b, s = (torch.tensor(a, requires_grad=True) for a in (qkv, bias,
                                                             scale))
    out, _ = window_attention_flat_sharded(q, b, s, shift, 2, 2,
                                           dist.group.WORLD)
    loss = (out * torch.cos(out)).sum()
    loss.backward()
    return _np(out), float(loss), _np(q.grad), _np(b.grad), _np(s.grad)


def _sp_indivisible(qkv, bias, scale):
    from mvuld_tpu_torch.ops.window_attention import (
        window_attention_flat_sharded)
    try:
        window_attention_flat_sharded(torch.tensor(qkv[:12]),
                                      torch.tensor(bias), torch.tensor(scale),
                                      0, 2, 2, dist.group.WORLD)
    except ValueError as e:
        return str(e)
    return "no error"


def _sp_model(cfg_kw, flat, x):
    """A tiny SwinV2 through the kernel path with the sequence-parallel
    attention, and without: logits, and the gradients of Σ logits²."""
    from mvuld_tpu_torch.models.convert import jax_variables_to_torch
    from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                SwinV2Config,
                                                sequence_parallel)
    res = []
    for sp in (True, False):
        model = SwinTransformerV2(SwinV2Config(**cfg_kw), use_pallas=True,
                                  num_classes=2)
        jax_variables_to_torch(flat, model)
        if sp:
            sequence_parallel(model, dist.group.WORLD)
        logits = model(torch.tensor(x))
        grads = torch.autograd.grad((logits ** 2).sum(),
                                    list(model.parameters()))
        res.append((_np(logits), [_np(g) for g in grads]))
    return res


def _moe(rank, world, kw, flat, x, grads):
    """The expert-parallel MoE on this rank's block of tokens: its output
    and aux loss; with ``grads``, the gradients of Σ y·w (w seeded) of x
    and of the parameters, and the same from the one-rank MoE on the
    whole batch."""
    from mvuld_tpu_torch.models.moe import MoEFFN, expert_parallel
    full = MoEFFN(**kw)
    with torch.no_grad():
        for k, v in flat.items():
            getattr(full, k).copy_(torch.tensor(v))
    ep = expert_parallel(copy.deepcopy(full), dist.group.WORLD)
    xt = torch.tensor(x)
    n = xt.shape[0] // world
    mine = xt[rank * n:(rank + 1) * n].clone().requires_grad_(grads)
    y, aux = ep(mine)
    out = {"y": _np(y), "aux": float(aux),
           "routing": [_np(t) for t in ep.routing]}
    if grads:
        w = torch.randn(xt.shape[:-1] + (kw["out"],),
                        generator=torch.Generator().manual_seed(3))
        (y * w[rank * n:(rank + 1) * n]).sum().backward()
        out["dx"] = _np(mine.grad)
        out["dw1"] = _np(ep.w1.grad)
        out["dgate"] = _np(cc.all_reduce(ep.gate.grad, dist.group.WORLD))
        xf = xt.clone().requires_grad_(True)
        yf, _ = full(xf)
        (yf * w).sum().backward()
        E, k = kw["num_experts"], world
        out["dx_one"] = _np(xf.grad[rank * n:(rank + 1) * n])
        out["dw1_one"] = _np(full.w1.grad[rank * E // k:(rank + 1) * E // k])
        out["dgate_one"] = _np(full.gate.grad)
    return out


def _tp_step(mesh, cfg_kw, flat, x, y):
    """One AdamW step of a tiny SwinV2 on the (dp 2, mp 2) mesh, its
    weights split by ``shard_params_tp``, against the one-rank step on the
    whole batch sliced the same way."""
    from mvuld_tpu_torch.core.train_state import image_inputs
    from mvuld_tpu_torch.parallel.mesh import (shard_batch, shard_params_tp,
                                               tp_global_norm)

    def model():
        return swin_model(cfg_kw, flat)

    batch = {"image": torch.tensor(x), "label": torch.tensor(y).long()}
    one, one_grads, one_sd = _step(model(), batch, image_inputs)
    ref = model()
    ref.load_state_dict({k: torch.tensor(v) for k, v in one_sd.items()})
    shard_params_tp(mesh, ref)
    tp = model()
    sharded = shard_params_tp(mesh, tp)
    got, _, sd = _step(tp, shard_batch(mesh, batch), image_inputs, mesh,
                       tp_global_norm(mesh, sharded, tp))
    return {"one": one, "tp": got, "sharded": sharded,
            "param_diff": _max_diffs(sd, {k: _np(v) for k, v in
                                          ref.state_dict().items()}),
            "shapes": {k: v.shape for k, v in sd.items()}}


# ------------------------------------------------------------- world 2

def world2(rank, world, zoo_case, swin_case, toy_case, moe_cases, text_case):
    from mvuld_tpu_torch.models.dropout import keep_mask
    from mvuld_tpu_torch.parallel.mesh import make_mesh, rank_seed

    torch.set_num_threads(1)
    mesh = make_mesh()
    out = {"zoo": _dp_parity(mesh, *zoo_case),
           "swin": _dp_parity(mesh, *swin_case),
           "toy": _learns(mesh, *toy_case),
           "moe": [_moe(rank, world, *case) for case in moe_cases]}
    gen = torch.Generator().manual_seed(rank_seed(mesh, 0))
    mask = keep_mask((64,), 0.5, gen, "cpu")
    out["masks"] = _np(cc.all_gather(mask[None].float(), mesh.dp_group))
    out["text"] = [_train_text(argv) for argv in text_case]
    return out


def zoo_model(sizes):
    """``multi_defect_new_gcn`` (dropout 0) with seed-0 JAX-like weights."""
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.fusion_zoo import build_fusion_model
    m = build_fusion_model(None, "multi_defect_new_gcn", **sizes,
                           dropout=0.0, final_dropout=0.0)
    init_jax_like(m, torch.Generator().manual_seed(0))
    return m


def swin_model(cfg_kw, flat):
    """A SwinV2 with a 2-class head loaded from JAX variables."""
    from mvuld_tpu_torch.models.convert import jax_variables_to_torch
    from mvuld_tpu_torch.models.swin_v2 import SwinTransformerV2, SwinV2Config
    m = SwinTransformerV2(SwinV2Config(**cfg_kw), num_classes=2)
    jax_variables_to_torch(flat, m)
    return m


def _zoo_inputs(batch):
    return {k: v for k, v in batch.items() if k != "label"}


def _dp_parity(mesh, build, batch, inputs_name):
    """One step at world 1 (whole batch, no mesh) against the data-parallel
    step (this rank's rows, synced BatchNorm): metrics, gradients, the
    state dict after the step (parameters and BatchNorm statistics)."""
    from mvuld_tpu_torch.core.train_state import image_inputs
    from mvuld_tpu_torch.parallel.mesh import (replicate, shard_batch,
                                               sync_batch_norm)
    inputs = {"zoo": _zoo_inputs, "image": image_inputs}[inputs_name]
    batch = {k: torch.tensor(v) for k, v in batch.items()}
    torch.manual_seed(0)
    one, g1, sd1 = _step(build(), batch, inputs)
    model = sync_batch_norm(mesh, replicate(mesh, build()))
    dp, g2, sd2 = _step(model, shard_batch(mesh, batch), inputs, mesh)
    return {"one": one, "dp": dp, "grads": (g1, g2), "state": (sd1, sd2)}


def _learns(mesh, xs, ys):
    """A two-layer toy classifier trained 30 data-parallel steps
    (test_parallel.py::test_sharded_train_step_runs_and_learns)."""
    from mvuld_tpu_torch.core.optim import Optimizer
    from mvuld_tpu_torch.core.train_state import train_step
    from mvuld_tpu_torch.parallel.mesh import (gather_batch, replicate,
                                               shard_batch)

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = torch.nn.Sequential(torch.nn.Linear(8, 16),
                                           torch.nn.ReLU(),
                                           torch.nn.Linear(16, 2))

        def forward(self, x, train=False, gen=None):
            return self.net(x)

    torch.manual_seed(1 + mesh.rank)          # replicate() must align them
    model = replicate(mesh, Toy())
    params = list(model.named_parameters())
    opt = Optimizer(params, {n: False for n, _ in params}, lambda c: 1e-2)
    batch = shard_batch(mesh, {"x": torch.tensor(xs),
                               "label": torch.tensor(ys).long()})
    losses = [float(train_step(model, opt, batch, None, 0.0,
                               lambda b: {"x": b["x"]}, mesh=mesh)["loss"])
              for _ in range(30)]
    with torch.no_grad():
        logits = gather_batch(mesh, model(batch["x"]))
    return losses, _np(logits), opt.count


def _train_text(argv):
    """``train_text.main`` inside the world: the metrics, and the files
    this rank left in the run directory."""
    import os

    from mvuld_tpu_torch.train.train_text import main
    res = main(argv)
    out_dir = argv[argv.index("--output") + 1]
    files = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                   for d, _, fs in os.walk(out_dir) for f in fs)
    return {"test_metrics": res.get("test_metrics"),
            "history": res.get("history"), "files": files}
