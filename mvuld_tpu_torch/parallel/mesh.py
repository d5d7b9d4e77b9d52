"""The (dp, mp) grid of ranks: data and tensor parallelism.

Counterpart of ``mvuld_tpu/parallel/mesh.py``. The JAX package lays its
devices out as ``Mesh(devices, ("dp", "mp"))`` inside one program and lets
XLA place the collectives; the port runs one process per rank and lays the
ranks out the same way, rank = d·mp + m, with one process group per axis:
the dp group of a rank holds the ranks of its column m, the mp group the
ranks of its row d.

Data parallelism, with JAX's global-batch semantics:

  * every rank builds the same global batch from the same seeded loader and
    keeps its contiguous block of rows (``shard_batch``, JAX's ``P("dp")``),
    so host-side work on the global batch (mixup) matches one rank's run;
  * the gradients are averaged over dp before ``clip_by_global_norm``
    (``reduce_gradients``), which is the gradient of the mean over the
    global batch;
  * BatchNorm takes its training statistics over the global batch
    (``sync_batch_norm`` hands each BatchNorm the dp group; ``batch_norm``
    all-reduces the sums);
  * dropout and DropPath masks are drawn per rank (``rank_seed``): the JAX
    package draws the global batch's masks from one key, which a process
    holding only its rows cannot reproduce, so dp parity holds at rate 0;
  * the mp ranks of a dp block hold the same rows and the same replicated
    parameters, as the JAX trainers replicate their state over mp.

Tensor parallelism (``tp_spec``, ``shard_params_tp``) splits SwinV2's
weights by JAX's name rules: column-parallel ``fc1``, ``intermediate``,
``cpb_fc1``, ``qkv`` (output features), row-parallel ``fc2``,
``mlp_output`` and ``proj`` under ``attn`` (input features, the partial
outputs summed over mp). The qkv split keeps whole heads: rank m holds the
q, k and v rows of heads [m·H/mp, (m+1)·H/mp). Parameters the rules leave
whole (LayerNorms, ``cpb_fc2``, ``logit_scale``, ``q_bias``/``v_bias``)
stay replicated and are sliced to the rank's heads in the forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mvuld_tpu_torch.parallel import collectives as cc

SEED_STRIDE = 1_000_003      # between the dp ranks' dropout seeds


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (dp, mp) grid. ``ranks`` [dp, mp] holds the
    global ranks; ``dp_group`` / ``mp_group`` are None in a process with no
    process group (a one-rank world: every collective is the identity)."""

    ranks: np.ndarray
    rank: int = 0
    dp_group: Any = None
    mp_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.ranks.shape[0], "mp": self.ranks.shape[1]}

    @property
    def dp_rank(self) -> int:
        return self.rank // self.ranks.shape[1]

    @property
    def mp_rank(self) -> int:
        return self.rank % self.ranks.shape[1]

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def make_mesh(dp: int = -1, mp: int = 1) -> Mesh:
    """The (dp, mp) grid over the ranks of the default process group (one
    rank without one); ``dp`` ∈ {-1, 0} takes world // mp. Every rank must
    call it, in the same order as any other group creation."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp in (-1, 0):
        dp = world // mp
    if dp * mp > world:
        raise ValueError(f"mesh {dp}×{mp} needs {dp*mp} devices, "
                         f"have {world}")
    if dp * mp != world:
        raise ValueError(f"mesh {dp}×{mp} leaves {world - dp*mp} of {world} "
                         f"ranks idle: launch dp×mp ranks")
    ranks = np.arange(world).reshape(dp, mp)
    if not dist.is_initialized():
        return Mesh(ranks)
    rank = dist.get_rank()
    dp_group = mp_group = None
    for m in range(mp):                       # every rank creates every group
        g = dist.new_group(ranks[:, m].tolist())
        if rank in ranks[:, m]:
            dp_group = g
    for d in range(dp):
        g = dist.new_group(ranks[d].tolist())
        if rank in ranks[d]:
            mp_group = g
    return Mesh(ranks, rank, dp_group, mp_group)


def mesh_from_cfg(cfg, device) -> Mesh:
    """Initialise the process group from torchrun's environment when it
    names a world, then ``make_mesh(PARALLEL.DP, PARALLEL.MP)``."""
    from mvuld_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed)
    maybe_initialize_distributed(device)
    return make_mesh(cfg.PARALLEL.DP, cfg.PARALLEL.MP)


@contextlib.contextmanager
def primary_first(mesh: Optional[Mesh]):
    """The body runs on the primary rank first and then on the others (a
    cache or tokenizer the primary writes and the others read)."""
    if mesh is not None and not mesh.is_primary:
        cc.barrier()
    yield
    if mesh is not None and mesh.is_primary:
        cc.barrier()


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's contiguous block of every column's rows (numpy arrays
    or tensors). The global batch must divide over dp."""
    dp = mesh.shape["dp"]
    if dp == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % dp:
            raise ValueError(f"shard_batch: {k!r} has {n} rows, not a "
                             f"multiple of dp={dp}")
        lo = mesh.dp_rank * (n // dp)
        out[k] = v[lo:lo + n // dp]
    return out


def gather_batch(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The dp ranks' blocks of rows concatenated back into the global
    batch."""
    return cc.all_gather(t, mesh.dp_group) if mesh.shape["dp"] > 1 else t


def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0 (the
    JAX ``replicate``)."""
    if dist.is_initialized():
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                cc.broadcast_(t.data, 0, dist.group.WORLD)
    return module


def reduce_gradients(mesh: Mesh, grads: List[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """The gradients averaged over dp, in one flat all-reduce."""
    return cc.all_reduce_flat(grads, mesh.dp_group,
                              scale=1.0 / mesh.shape["dp"])


def mean_over_dp(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return cc.all_reduce(t, mesh.dp_group) / mesh.shape["dp"]


def sync_batch_norm(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Hand every BatchNorm of ``module`` the dp group: ``batch_norm``
    then takes its training statistics over the global batch."""
    from torch.nn.modules.batchnorm import _BatchNorm
    for m in module.modules():
        if isinstance(m, _BatchNorm):
            m.process_group = mesh.dp_group
    return module


def rank_seed(mesh: Mesh, seed: int) -> int:
    """The dropout generator's seed of this rank: ``seed`` on dp rank 0,
    distinct on every other dp rank, the same across a dp block's mp
    ranks (they compute the same rows)."""
    return seed + SEED_STRIDE * mesh.dp_rank


# --------------------------------------------------------------------------- #
# tensor parallelism
# --------------------------------------------------------------------------- #

_TP_COL = ("fc1", "intermediate", "cpb_fc1")     # split the output features
_TP_ROW = ("fc2", "mlp_output", "proj")          # split the input features


def tp_spec(path: str, ndim: int) -> Optional[str]:
    """How JAX's ``tp_spec`` lays out the parameter at the ``/``-joined
    JAX path: "col" (last axis of a kernel or bias over mp), "row" (axis
    -2 of a kernel over mp) or None (replicated)."""
    names = path.split("/")
    if ndim == 0:
        return None
    last = names[-1]
    if "qkv_kernel" in names:
        return "col"
    for i, n in enumerate(names[:-1]):
        if n in _TP_COL and last in ("kernel", "bias"):
            return "col"
        if n in _TP_ROW and last == "kernel" and ndim >= 2:
            # "proj" is also the patch embedding's conv: only the attention
            # output projection is row-parallel
            if n == "proj" and "attn" not in names[:i]:
                continue
            return "row"
    return None


def _shard(t: torch.Tensor, dim: int, k: int, m: int, groups: int = 1
           ) -> torch.Tensor:
    """Block m of k along ``dim``, taken within each of ``groups`` equal
    parts of the axis (qkv: within q, k and v)."""
    parts = t.chunk(groups, dim)
    return torch.cat([p.chunk(k, dim)[m] for p in parts], dim).contiguous()


def shard_params_tp(mesh: Mesh, model: nn.Module) -> List[str]:
    """Slice this rank's mp share out of a ``SwinTransformerV2``'s
    (converted, JAX-carried) parameters in place and switch its attention
    and MLP to the tensor-parallel forward. Returns the names of the
    sharded parameters. Call it before building the optimizer, whose
    moments take the parameters' shapes, and give that optimizer
    ``tp_global_norm(mesh, names, model)``. Another model raises: only
    SwinV2's attention and MLP have the tensor-parallel forward.

    Under mp > 1 the MLP half runs the plain layers: the fused fc1 → fc2 →
    LayerNorm kernel (K3) needs the summed fc2 output before its
    LayerNorm, so its split is not defined, as JAX's XLA path runs it."""
    from mvuld_tpu_torch.models.convert import torch_to_jax_names
    from mvuld_tpu_torch.models.swin_v2 import (MlpBlock, SwinBlockV2,
                                                SwinTransformerV2,
                                                WindowAttentionV2)

    if not isinstance(model, SwinTransformerV2):
        raise TypeError(f"shard_params_tp: {type(model).__name__} has no "
                        f"tensor-parallel forward (SwinTransformerV2 has)")
    k, m = mesh.shape["mp"], mesh.mp_rank
    names = torch_to_jax_names(model)
    sharded = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            spec = tp_spec(names[name], p.dim())
            if spec is None:
                continue
            # torch Linear weights are [out, in]: JAX's last axis is dim 0
            dim = 1 if spec == "row" else 0
            groups = 3 if "qkv_kernel" in names[name] else 1
            if p.shape[dim] % (k * groups):
                raise ValueError(f"shard_params_tp: {name} {tuple(p.shape)} "
                                 f"does not split over mp={k}")
            p.data = _shard(p.data, dim, k, m, groups)
            sharded.append(name)
    for mod in model.modules():
        if isinstance(mod, (WindowAttentionV2, MlpBlock)):
            mod.tp = mesh.mp_group
        if isinstance(mod, SwinBlockV2):
            mod.use_pallas_mlp = False
    return sharded


def tp_global_norm(mesh: Mesh, sharded: List[str], model: nn.Module):
    """The optimizer's ``norm`` under tensor parallelism: the global norm
    of the whole (unsharded) gradient, the sharded parameters' squares
    summed over mp, the replicated ones counted once."""
    is_sharded = [n in set(sharded) for n, _ in model.named_parameters()]

    def norm(grads: List[torch.Tensor]) -> torch.Tensor:
        dev = grads[0].device
        sq = lambda gs: sum((g.float() * g.float()).sum().to(dev)  # noqa: E731
                            for g in gs)
        rep = sq([g for g, s in zip(grads, is_sharded) if not s])
        part = sq([g for g, s in zip(grads, is_sharded) if s])
        return torch.sqrt(rep + cc.all_reduce(torch.as_tensor(
            part, device=dev), mesh.mp_group))

    return norm
