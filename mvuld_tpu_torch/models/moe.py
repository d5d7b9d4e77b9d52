"""Mixture-of-Experts FFN — the Swin-MoE layer, in PyTorch.

Counterpart of ``mvuld_tpu/models/moe.py`` (the reference's tutel
``moe_layer``, mvuld/models/swin_transformer_moe.py:17,71-87): top-k gating
with per-expert capacity C = max(⌊capacity_factor · k · T / E⌋, 1) over the
T tokens of the batch, the experts' two-layer GELU MLPs, and the GShard
load-balancing loss aux_weight · E · Σ_e mean(probs_e) · mean(onehot(argmax)_e).

The same function in the port's idiom. JAX builds dense one-hot
``combine``/``dispatch`` tensors [T, E, C] and contracts them with
einsums; here each (token, pass) gets its slot (the per-expert running
count of the pass's assignments, offset by the counts of the earlier
passes, so first and second choices never share a slot; a slot ≥ C drops
the assignment), the kept tokens move into [E·C, D] with one
``index_add`` (every slot holds at most one token), the experts run as
batched products over [E, C, ·], and each token gathers its k expert
outputs back, weighted by its gate probability. Dropped assignments go to
a spare row and weigh 0, so nothing waits on the host for a count.

Ties break toward the lowest expert index, as ``jax.lax.top_k`` and
``jnp.argmax`` do: the k choices are taken by repeated ``argmax`` (which
returns the first maximum) with the chosen expert masked out.

The expert weights keep JAX's layout: ``gate`` [D, E], ``w1`` [E, D, Hd],
``b1`` [E, 1, Hd], ``w2`` [E, Hd, out], ``b2`` [E, 1, out], plain
parameters (not ``nn.Linear``), so the JAX variables load without a
transpose. Gate noise (logits + N(0, 1) · gate_noise / E) is drawn in
training from the step's generator; JAX's draw cannot be reproduced, so
parity holds in evaluation and with ``gate_noise`` 0. After each forward
``routing`` holds the pass-major expert choice [k, T] and keep-mask
[k, T] (detached), for the callers that compare routings or count drops.

Expert parallelism (``expert_parallel``; JAX shards the expert axis over
"mp" and XLA inserts the all-to-alls): over a group of k ranks, each rank
holds E/k experts (rank j experts [j·E/k, (j+1)·E/k)) and its own tokens,
its block of the global token order (every rank the same count). JAX's
global semantics are kept: C from the global token count, and each pass's
slots by a cumsum over the global token order — the ranks' per-expert
counts are all-gathered and their exclusive prefix over ranks offsets
each rank's local cumsum (after the earlier passes' global counts). The
[E, C, D] dispatch goes to the expert owners by one all-to-all (each slot
holds one token of one rank, so the owner sums what it receives) and the
owners' outputs come back by another; the aux loss's means are summed
over the group. The gate noise is the global tokens' draw: each rank
draws the k ranks' rows from ``gen`` and keeps its own block (also under
data parallelism, ``models/dropout.draw_rows``), so the ranks' noise
differs and their generators stay in step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvuld_tpu_torch.models.dropout import draw_rows, dropout
from mvuld_tpu_torch.ops.fused_dense import gelu
from mvuld_tpu_torch.parallel import collectives as cc


def top_k_lowest(probs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [T, k], indices [T, k]) of the k largest entries per row,
    ties to the lowest index (``jax.lax.top_k``)."""
    vals, idx = [], []
    p = probs
    for _ in range(k):
        i = torch.argmax(p, dim=-1)
        idx.append(i)
        vals.append(probs.gather(-1, i[:, None])[:, 0])
        p = p.masked_fill(F.one_hot(i, p.shape[-1]).bool(), float("-inf"))
    return torch.stack(vals, -1), torch.stack(idx, -1)


class MoEFFN(nn.Module):
    """gate → dispatch (capacity-dropped) → expert MLPs → combine; forward
    returns (y, aux)."""

    def __init__(self, dim: int, hidden: int, out: int, num_experts: int = 4,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 gate_noise: float = 1.0, aux_weight: float = 0.01,
                 drop: float = 0.0):
        super().__init__()
        E = self.num_experts = num_experts
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.gate_noise, self.aux_weight, self.drop = (gate_noise, aux_weight,
                                                       drop)
        self.gate = nn.Parameter(torch.zeros(dim, E))
        self.w1 = nn.Parameter(torch.zeros(E, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(E, 1, hidden))
        self.w2 = nn.Parameter(torch.zeros(E, hidden, out))
        self.b2 = nn.Parameter(torch.zeros(E, 1, out))
        self.routing: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.ep = None          # the expert-parallel group

    def capacity(self, tokens: int) -> int:
        return max(int(self.capacity_factor * self.top_k * tokens
                       / self.num_experts), 1)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [..., D] → (y [..., out] in ``dtype`` (x's by default), aux
        scalar). ``gen``: training's generator (gate noise, dropout)."""
        dt = dtype or x.dtype
        acc = torch.promote_types(dt, torch.float32)
        lead, D = x.shape[:-1], x.shape[-1]
        tokens = x.reshape(-1, D)
        T, E, K = tokens.shape[0], self.num_experts, self.top_k
        g, nr, me = self.ep, cc.size(self.ep), cc.rank(self.ep)
        C = self.capacity(T * nr)                 # the global token count

        logits = tokens.to(acc) @ self.gate.to(acc)              # [T, E]
        if gen is not None and self.gate_noise > 0:
            # the global tokens' noise (rank-major under expert or data
            # parallelism), this rank's rows kept
            noise = draw_rows(torch.randn, (nr * T, E), gen, logits.device,
                              dtype=acc)[me * T:(me + 1) * T]
            logits = logits + noise * self.gate_noise / E
        probs = torch.softmax(logits, dim=-1)

        # GShard load-balancing loss over the first choices
        first = F.one_hot(torch.argmax(probs, dim=-1), E).to(acc)
        if g is None:
            aux = self.aux_weight * E * (probs.mean(0) * first.mean(0)).sum()
        else:
            means = cc.all_reduce_fn(torch.stack([probs.sum(0),
                                                  first.sum(0)]), g) / (T * nr)
            aux = self.aux_weight * E * (means[0] * means[1]).sum()

        topk_p, topk_e = top_k_lowest(probs, K)                 # [T, K]
        prior = torch.zeros(E, dtype=torch.long, device=x.device)
        rows, keeps = [], []
        for k in range(K):
            e_k = topk_e[:, k]
            onehot = F.one_hot(e_k, E)                           # [T, E]
            counts, before = onehot.sum(0), prior    # earlier passes first
            if g is not None:     # then the earlier ranks' tokens
                every = cc.all_gather(counts[None], g)           # [nr, E]
                before = before + every[:me].sum(0)
                counts = every.sum(0)
            slot = (onehot.cumsum(0).gather(1, e_k[:, None])[:, 0] - 1
                    + before[e_k])
            keep = slot < C
            prior = prior + counts
            # a dropped assignment goes to the spare row E·C
            rows.append(torch.where(keep, e_k * C + slot,
                                    torch.full_like(slot, E * C)))
            keeps.append(keep)
        rows_t, keeps_t = torch.stack(rows), torch.stack(keeps)  # [K, T]
        self.routing = (topk_e.t().detach(), keeps_t.detach())

        # expert inputs [E, C, D]: each slot holds at most one token
        xe = tokens.new_zeros(E * C + 1, D).index_add(
            0, rows_t.reshape(-1), tokens.repeat(K, 1))
        xe = xe[:E * C].reshape(E, C, D).to(dt)
        if g is not None:         # to the owners: [nr, E/nr, C, D] summed
            xe = cc.all_to_all_fn(xe, g).reshape(nr, E // nr, C, D).sum(0)
        h = torch.baddbmm(self.b1.to(dt), xe, self.w1.to(dt))
        h = dropout(gelu(h), self.drop, gen)
        ye = torch.baddbmm(self.b2.to(dt), h, self.w2.to(dt))   # [E, C, out]
        if g is not None:         # every owner's outputs to every rank
            ye = cc.all_to_all_fn(ye.repeat(nr, 1, 1), g)

        # combine: Σ_k topk_p·keep · ye[e_k, slot_k], the weights rounded
        # to ye's dtype (JAX's combine.astype), the sum in fp32
        ye = torch.cat([ye.reshape(E * C, -1),
                        ye.new_zeros(1, ye.shape[-1])]).to(acc)
        w = (topk_p * keeps_t.t().to(acc)).t().to(dt).to(acc)    # [K, T]
        y = (w[:, :, None] * ye[rows_t]).sum(0)
        return y.to(dt).reshape(*lead, -1), aux


def expert_parallel(module: nn.Module, group) -> nn.Module:
    """Shard every ``MoEFFN`` of ``module`` over ``group``: each rank keeps
    its E/k experts' slices of ``w1``, ``b1``, ``w2``, ``b2`` (a converted
    one-card set sliced in place) and routes over the group."""
    k, j = cc.size(group), cc.rank(group)
    for m in module.modules():
        if isinstance(m, MoEFFN):
            if m.num_experts % k:
                raise ValueError(f"expert_parallel: {m.num_experts} experts "
                                 f"do not divide over {k} ranks")
            n = m.num_experts // k
            with torch.no_grad():
                for p in (m.w1, m.b1, m.w2, m.b2):
                    p.data = p.data[j * n:(j + 1) * n].contiguous()
            m.ep = group
    return module


def make_moe_mlp_layer(num_experts: int, top_k: int, capacity_factor: float,
                       gate_noise: float, aux_weight: float):
    """``SwinBlockV1``'s ``mlp_layer(hidden, out, drop)``: a ``MoEFFN`` over
    the block's width."""

    def factory(hidden: int, out: int, drop: float) -> MoEFFN:
        return MoEFFN(out, hidden, out, num_experts, top_k, capacity_factor,
                      gate_noise, aux_weight, drop)

    return factory
