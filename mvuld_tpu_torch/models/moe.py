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
batched products over [E, C, ·], and each token takes its k expert
outputs back, weighted by its gate probability, by a second ``index_add``
from the slots to the tokens. A dropped assignment goes to a spare row of
its own and weighs 0, and an empty slot to one of its own: no row takes
two, so nothing waits on the host for a count, both backwards are
gathers that sum nothing, and their time does not depend on how many
assignments are dropped.

Ties break toward the lowest expert index, as ``jax.lax.top_k`` and
``jnp.argmax`` do: the k choices are taken by repeated ``argmax`` (which
returns the first maximum) with the chosen expert masked out.

The expert weights keep JAX's layout: ``gate`` [D, E], ``w1`` [E, D, Hd],
``b1`` [E, 1, Hd], ``w2`` [E, Hd, out], ``b2`` [E, 1, out] (None without
an fc2 bias), plain parameters (not ``nn.Linear``), so the JAX variables
load without a transpose. Gate noise (logits + N(0, 1) · gate_noise / E) is
drawn in training from the step's generator; JAX's draw cannot be
reproduced, so parity holds in evaluation and with ``gate_noise`` 0. After
each forward ``routing`` holds the pass-major expert choice [k, T] and
keep-mask [k, T] (detached), for the callers that compare routings or
count drops.

Upstream Swin-MoE's settings (Tutel's ``extract_critical`` and
``load_importance_loss`` as Swin-MoE calls them, ``fp32_gate``). The
defaults (``bpr=False``, ``gshard_loss=True``, ``fc2_bias=True``) are the
JAX package's semantics; ``models/swin_variants`` passes MODEL.SWIN_MOE's
USE_BPR, IS_GSHARD_LOSS, MLP_FC2_BIAS and MOE_DROP. With x a token:

* gate: logits = x·W_g in fp32, no bias; in training ñ = logits +
  gate_noise·ε/E, ε ~ N(0, 1) from the step's generator (else ñ = logits);
  scores = softmax(ñ);
* choice: e(t) = argmax scores[t] (ties to the lowest expert), g(t) =
  scores[t, e(t)]; Tutel's NORMALIZE_GATE acts only for k > 1 and is not
  taken here;
* batch-prioritized routing (``bpr``, V-MoE): the first choices take
  their slots in descending order of the token's max score (a stable
  sort: equal scores keep token order); a token's slot is the number of
  earlier tokens in that order that chose the same expert, and the token
  is kept iff slot < C. Without BPR the order is the token order. Later
  passes (k > 1) take token order after the earlier passes' counts, as
  Tutel's. C is the port's; it equals Tutel's k·⌊cf·⌈T/E⌉⌋ whenever E
  divides T (Swin-MoE-B/32 at batch 128: T = 128·144 and 128·36, C = 720
  and 180);
* expert: y = g·fc2(dropout_drop(gelu(fc1 x))) for a kept token, 0 for a
  dropped one; the dropout mask is drawn over the [E, C, Hd] slot layout;
  fc2 has no bias without ``fc2_bias``;
* aux loss without ``gshard_loss`` (the load-importance loss): p =
  softmax(logits) without the noise, θ(t) the noisy logit ñ of t's k-th
  choice, σ = gate_noise/E, cv²(v) = var(v)/(mean(v)² + 1e-10) with the
  unbiased variance, l = ½·[cv²(Σ_t p(t)) + cv²(Σ_t Φ((p(t) − θ(t))/σ))]
  with Φ the normal CDF; the layer returns aux_weight · l (the step adds
  AUX_LOSS_WEIGHT · Σ_layers l to the cross-entropy). It needs
  gate_noise > 0.

Device counters, int64 buffers incremented inside the forward so that a
CUDA graph replay counts too: ``routed`` assignments (T·k), ``kept``
assignments and capacity ``slots`` (E·C), once per forward the step takes
(a checkpointed recomputation, which runs inside the backward, does not
count). ``routing_counters`` sums them over a model,
``reset_routing_counters`` clears them in place.

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
owners' outputs come back by another; the aux loss's sums are summed
over the group. The gate noise is the global tokens' draw: each rank
draws the k ranks' rows from ``gen`` and keeps its own block (also under
data parallelism, ``models/dropout.draw_rows``), so the ranks' noise
differs and their generators stay in step. BPR is not sharded: its
priority order runs over the global tokens, and Tutel's per-rank capacity
differs from the port's global slots, so ``expert_parallel`` refuses a
layer with ``bpr``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvuld_tpu_torch.models.dropout import draw_rows, dropout
from mvuld_tpu_torch.ops.fused_dense import gelu
from mvuld_tpu_torch.parallel import collectives as cc

COUNTERS = ("routed", "kept", "slots")


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


def cv_squared(v: torch.Tensor) -> torch.Tensor:
    """var(v) / (mean(v)² + 1e-10), the variance unbiased (Tutel's)."""
    return v.var() / (v.mean() ** 2 + 1e-10)


def _recomputing() -> bool:
    """A forward run inside the backward: a checkpoint's recomputation."""
    return torch._C._current_graph_task_id() != -1


class MoEFFN(nn.Module):
    """gate → dispatch (capacity-dropped) → expert MLPs → combine; forward
    returns (y, aux)."""

    def __init__(self, dim: int, hidden: int, out: int, num_experts: int = 4,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 gate_noise: float = 1.0, aux_weight: float = 0.01,
                 drop: float = 0.0, bpr: bool = False,
                 gshard_loss: bool = True, fc2_bias: bool = True):
        super().__init__()
        if not gshard_loss and gate_noise <= 0:
            raise ValueError("the load-importance loss needs gate_noise > 0 "
                             "(σ = gate_noise / E)")
        E = self.num_experts = num_experts
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.gate_noise, self.aux_weight, self.drop = (gate_noise, aux_weight,
                                                       drop)
        self.bpr, self.gshard_loss = bpr, gshard_loss
        self.gate = nn.Parameter(torch.zeros(dim, E))
        self.w1 = nn.Parameter(torch.zeros(E, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(E, 1, hidden))
        self.w2 = nn.Parameter(torch.zeros(E, hidden, out))
        self.b2 = (nn.Parameter(torch.zeros(E, 1, out)) if fc2_bias
                   else None)
        for name in COUNTERS:
            self.register_buffer(name, torch.zeros((), dtype=torch.long),
                                 persistent=False)
        self.routing: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.ep = None          # the expert-parallel group

    def capacity(self, tokens: int) -> int:
        return max(int(self.capacity_factor * self.top_k * tokens
                       / self.num_experts), 1)

    def _aux(self, logits, noisy, probs, topk_e, T: int) -> torch.Tensor:
        """The layer's aux loss, aux_weight · l (module docstring)."""
        g, nr, E = self.ep, cc.size(self.ep), self.num_experts
        if self.gshard_loss:
            # GShard over the first choices, on the noisy probabilities
            first = F.one_hot(topk_e[:, 0], E).to(probs.dtype)
            sums = torch.stack([probs.sum(0), first.sum(0)])
            if g is not None:
                sums = cc.all_reduce_fn(sums, g)
            means = sums / (T * nr)
            return self.aux_weight * E * (means[0] * means[1]).sum()
        p = torch.softmax(logits, dim=-1)
        theta = noisy.gather(1, topk_e[:, -1:])
        load = torch.special.ndtr((p - theta) / (self.gate_noise / E))
        sums = torch.stack([p.sum(0), load.sum(0)])
        if g is not None:
            sums = cc.all_reduce_fn(sums, g)
        return self.aux_weight * 0.5 * (cv_squared(sums[0])
                                        + cv_squared(sums[1]))

    def _slots(self, topk_p, topk_e, C: int):
        """(rows [K, T]: e·C + slot for a kept assignment, else its own
        spare row E·C + k·T + t; keeps [K, T])."""
        g, me = self.ep, cc.rank(self.ep)
        E, K, T = self.num_experts, self.top_k, topk_e.shape[0]
        dev = topk_e.device
        experts = torch.arange(E, device=dev)
        tok = torch.arange(T, device=dev)
        prior = torch.zeros(E, dtype=torch.long, device=dev)
        rows, keeps = [], []
        for k in range(K):
            e_k = topk_e[:, k]
            order = None
            if k == 0 and self.bpr:
                # capacity to the most confident first choices first
                order = torch.sort(topk_p[:, 0], descending=True,
                                   stable=True).indices
                e_k = e_k[order]
            # [E, T]: each expert's running count along its row (a scan
            # along the inner dimension; down [T, E]'s few columns it
            # runs nearly serially)
            hit = (experts[:, None] == e_k[None, :]).long()
            counts, before = hit.sum(1), prior      # earlier passes first
            if g is not None:     # then the earlier ranks' tokens
                every = cc.all_gather(counts[None], g)           # [nr, E]
                before = before + every[:me].sum(0)
                counts = every.sum(0)
            slot = (hit.cumsum(1).gather(0, e_k[None, :])[0] - 1
                    + before[e_k])
            if order is not None:         # back to token order
                slot = torch.empty_like(slot).scatter_(0, order, slot)
                e_k = topk_e[:, k]
            keep = slot < C
            prior = prior + counts
            rows.append(torch.where(keep, e_k * C + slot,
                                    E * C + k * T + tok))
            keeps.append(keep)
        return torch.stack(rows), torch.stack(keeps)

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
        if self.ep is not None and self.bpr:
            raise NotImplementedError("batch-prioritized routing is not "
                                      "sharded over experts")
        g, nr, me = self.ep, cc.size(self.ep), cc.rank(self.ep)
        C = self.capacity(T * nr)                 # the global token count

        logits = tokens.to(acc) @ self.gate.to(acc)          # [T, E]
        noisy = logits
        if gen is not None and self.gate_noise > 0:
            # the global tokens' noise (rank-major under expert or
            # data parallelism), this rank's rows kept
            noise = draw_rows(torch.randn, (nr * T, E), gen, logits.device,
                              dtype=acc)[me * T:(me + 1) * T]
            noisy = logits + noise * self.gate_noise / E
        probs = torch.softmax(noisy, dim=-1)
        topk_p, topk_e = top_k_lowest(probs, K)              # [T, K]
        aux = self._aux(logits, noisy, probs, topk_e, T)
        rows_t, keeps_t = self._slots(topk_p, topk_e, C)     # [K, T]
        self.routing = (topk_e.t().detach(), keeps_t.detach())
        if not _recomputing():
            self.routed.add_(T * K)
            self.kept.add_(keeps_t.sum())
            self.slots.add_(E * C)

        # expert inputs [E, C, D]: every row takes at most one token
        xe = tokens.new_zeros(E * C + K * T, D).index_add(
            0, rows_t.reshape(-1), tokens.repeat(K, 1))
        xe = xe[:E * C].reshape(E, C, D).to(dt)
        if g is not None:     # to the owners: [nr, E/nr, C, D] summed
            xe = cc.all_to_all_fn(xe, g).reshape(nr, E // nr, C, D).sum(0)

        h = torch.baddbmm(self.b1.to(dt), xe, self.w1.to(dt))
        h = dropout(gelu(h), self.drop, gen)
        ye = (torch.bmm(h, self.w2.to(dt)) if self.b2 is None
              else torch.baddbmm(self.b2.to(dt), h, self.w2.to(dt)))
        if g is not None:     # every owner's outputs to every rank
            ye = cc.all_to_all_fn(ye.repeat(nr, 1, 1), g)

        # Σ_k topk_p·keep · ye[e_k, slot_k], the weights rounded to ye's
        # dtype (JAX's combine.astype), the sum in fp32. Each pass's slots go
        # back to their tokens by a scatter whose rows are distinct (an empty
        # slot to a spare row of its own), so the backward gathers and sums
        # nothing
        ye = ye.reshape(E * C, -1).to(acc)
        w = (topk_p * keeps_t.t().to(acc)).t().to(dt).to(acc)   # [K, T]
        tok = torch.arange(T, device=x.device)
        spare = T + torch.arange(E * C + K * T, device=x.device)
        y = None
        for k in range(K):
            src = spare.scatter(0, rows_t[k], tok)[:E * C]
            out = ye.new_zeros(T + E * C, ye.shape[-1]).index_add(
                0, src, ye)[:T]
            y = w[k][:, None] * out if y is None else (
                y + w[k][:, None] * out)
        return y.to(dt).reshape(*lead, -1), aux


def routing_counters(module: nn.Module) -> Dict[str, int]:
    """{"routed", "kept", "slots"} summed over every ``MoEFFN`` of
    ``module`` since the last reset (one host read)."""
    layers = [m for m in module.modules() if isinstance(m, MoEFFN)]
    if not layers:
        return {k: 0 for k in COUNTERS}
    v = torch.stack([torch.stack([getattr(m, k) for k in COUNTERS])
                     for m in layers]).sum(0).tolist()
    return dict(zip(COUNTERS, v))


@torch.no_grad()
def reset_routing_counters(module: nn.Module) -> None:
    """Zero every ``MoEFFN``'s counters in place (a captured graph keeps
    adding to the same buffers)."""
    for m in module.modules():
        if isinstance(m, MoEFFN):
            for k in COUNTERS:
                getattr(m, k).zero_()


def expert_parallel(module: nn.Module, group) -> nn.Module:
    """Shard every ``MoEFFN`` of ``module`` over ``group``: each rank keeps
    its E/k experts' slices of ``w1``, ``b1``, ``w2``, ``b2`` (a converted
    one-card set sliced in place) and routes over the group. A layer with
    batch-prioritized routing raises ``NotImplementedError`` (module
    docstring)."""
    k, j = cc.size(group), cc.rank(group)
    for m in module.modules():
        if isinstance(m, MoEFFN):
            if m.bpr:
                raise NotImplementedError(
                    "expert_parallel: batch-prioritized routing orders the "
                    "global tokens, and Tutel's per-rank capacity differs "
                    "from the port's global slots")
            if m.num_experts % k:
                raise ValueError(f"expert_parallel: {m.num_experts} experts "
                                 f"do not divide over {k} ranks")
            n = m.num_experts // k
            with torch.no_grad():
                for p in (m.w1, m.b1, m.w2, m.b2):
                    if p is not None:
                        p.data = p.data[j * n:(j + 1) * n].contiguous()
            m.ep = group
    return module


def make_moe_mlp_layer(num_experts: int, top_k: int, capacity_factor: float,
                       gate_noise: float, aux_weight: float,
                       bpr: bool = False, gshard_loss: bool = True,
                       fc2_bias: bool = True, moe_drop: float = 0.0):
    """``SwinBlockV1``'s ``mlp_layer(hidden, out, drop)``: a ``MoEFFN`` over
    the block's width, its dropout rate ``moe_drop`` (MOE_DROP) in place of
    the block's ``drop``."""

    def factory(hidden: int, out: int, drop: float) -> MoEFFN:
        return MoEFFN(out, hidden, out, num_experts, top_k, capacity_factor,
                      gate_noise, aux_weight, moe_drop, bpr, gshard_loss,
                      fc2_bias)

    return factory
