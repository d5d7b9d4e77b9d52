"""Every collective the port issues, in one place.

The JAX package never calls a collective itself: under jit with shardings
XLA inserts them (``psum`` over "dp" for the gradient mean, the all-to-alls
of the expert axis, ``ppermute`` between pipeline stages). The port runs one
process per rank (``torch.distributed``), so its parallel layer
(``parallel/mesh.py``, the sequence-parallel attention, the expert-parallel
MoE, BatchNorm's synced statistics) calls these functions instead.

``group`` is a ``torch.distributed`` process group, or None for no group:
then every function is the identity of a one-rank world and issues nothing.

Backends. NCCL takes CUDA tensors natively. Gloo takes CPU tensors; on
CUDA tensors it implements only ``broadcast``, ``all_reduce`` and
``barrier``, so for ``all_gather`` and ``all_to_all`` of a CUDA tensor over
a gloo group the tensor is copied to the host for the call and the result
back to its device. That is the case of several ranks sharing one card
(NCCL refuses two ranks on one device): the computation stays on the card,
only the exchanged bytes cross to the host.

The ``*_fn`` autograd functions are the differentiable forms the models
use. Where the ranks hold different data (dp, the expert-parallel MoE's
tokens) each rank's loss is its own and the total is their sum:
``all_reduce_fn`` sums forward and backward, ``all_to_all_fn`` is its own
inverse. Inside a region that every rank of the group computes alike
(tensor parallelism) the loss is one replicated value: ``copy_to_fn`` is
the identity forward and sums the gradient backward, ``reduce_from_fn``
sums forward and passes the gradient through backward (Megatron's f and
g), ``all_gather_fn`` concatenates the ranks' blocks forward and keeps
each rank's own block of the (replicated) gradient backward.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _host_copy(t: torch.Tensor, group) -> bool:
    """True where a gloo group cannot take ``t`` where it lies."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) over ``group`` of every rank's ``t``, as a new
    tensor."""
    out = t.clone()
    if group is not None:
        dist.all_reduce(out, op=op, group=group)
    return out


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` overwritten in place with the group rank ``src``'s value."""
    if group is not None:
        dist.broadcast(t, dist.get_global_rank(group, src), group=group)
    return t


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (the default group when None) in an
    initialised world; nothing without one."""
    if dist.is_initialized():
        dist.barrier(group=group)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0, in group rank order (every
    rank's ``t`` has the same shape)."""
    if group is None:
        return t.clone()
    src = t.contiguous()
    if _host_copy(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 of ``t`` split into ``size(group)`` equal blocks, block j sent
    to group rank j; the result holds the received blocks in source rank
    order."""
    if group is None:
        return t.clone()
    src = t.contiguous()
    if _host_copy(src, group):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device)


def all_reduce_flat(tensors: List[torch.Tensor], group,
                    scale: Optional[float] = None) -> List[torch.Tensor]:
    """Each tensor summed over ``group`` (times ``scale``) in one call on
    one flat fp32 buffer; new tensors of the inputs' shapes and dtypes."""
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale is not None:
        flat.mul_(scale)
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].reshape(t.shape).to(t.dtype))
        lo += t.numel()
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.n = group, t.shape[0]
        return all_gather(t, group)

    @staticmethod
    def backward(ctx, g):
        lo = rank(ctx.group) * ctx.n
        return g[lo:lo + ctx.n], None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_fn(t, group):
    return t if group is None else _AllReduce.apply(t, group)


def all_gather_fn(t, group):
    return t if group is None else _AllGather.apply(t, group)


def all_to_all_fn(t, group):
    return t if group is None else _AllToAll.apply(t, group)


def copy_to_fn(t, group):
    return t if group is None else _CopyTo.apply(t, group)


def reduce_from_fn(t, group):
    return t if group is None else _ReduceFrom.apply(t, group)
