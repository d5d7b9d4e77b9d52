"""Plain PyTorch reference of Swin-MoE (Swin Transformer V1 blocks, some of
whose MLPs are top-1 mixtures of experts), frozen with the benchmark.

The model of microsoft/Swin-Transformer's ``swin_transformer_moe.py`` with
the routing of Tutel's ``moe_layer`` as Swin-MoE calls it (``fp32_gate``,
``extract_critical``, ``load_importance_loss``):

* pre-norm shifted-window blocks: scaled dot-product window attention
  (q·hd^-½) with the learned V1 relative-position bias table, the shift
  mask, one fused qkv bias; V1 patch merging (norm, then the reduction);
* an MoE layer takes all T tokens of the batch at once (capacity and the
  priority order need them all). Gate: logits = x·W_g (no bias); in
  training ñ = logits + gate_noise·ε/E with ε ~ N(0, 1) drawn by the
  caller; scores = softmax(ñ); each token's expert e(t) is its first
  maximum and g(t) its score. Capacity C = max(⌊cf·T/E⌋, 1). With batch-
  prioritized routing the tokens take their slots in descending order of
  g (equal scores in token order), else in token order; a token's slot is
  the number of earlier tokens in that order that chose its expert, and
  it is kept iff slot < C. A kept token's output is g·fc2(drop(gelu(fc1
  x))) through its expert, a dropped token's 0; the dropout mask lies
  over the [E, C, Hd] slot layout;
* the aux loss per MoE layer, weight · l: without the GShard loss
  (Swin-MoE's yaml) l = ½·[cv²(Σ_t p(t)) + cv²(Σ_t Φ((p(t) − θ(t))/σ))]
  with p = softmax(logits) (no noise), θ(t) the noisy logit of t's choice,
  σ = gate_noise/E, cv²(v) = var(v)/(mean(v)² + 1e-10) (unbiased var) and
  Φ the normal CDF; with it, l = E·Σ_e mean_t(scores_e)·mean_t(1[e(t)=e]).

Every product runs through ``models.mm`` (the control's precision).
Parameter names follow the port's and the upstream checkpoints' (``gate``
[D, E], ``w1`` [E, D, Hd], ``b1`` [E, 1, Hd], ``w2`` [E, Hd, D], ``b2``
[E, 1, D] when fc2 has a bias), so one table of seeded weights loads into
both. ``draw_masks`` draws one training forward's random numbers in the
order the measured trainer draws them; ``forward`` records each MoE
layer's choices and keep-masks in ``routes`` and, with ``remat``, runs
each block under activation checkpointing (the draws are given, so the
recomputation is the same function).

This file imports torch, numpy and the reference's shared helpers only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from benchmark.reference.models import (dense, gelu, keep_apply, mm,
                                        position_index, shift_mask,
                                        unwindows, windows)


def _ln(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return nn.functional.layer_norm(x, ln.normalized_shape, ln.weight,
                                    ln.bias, ln.eps)


def cv_squared(v: torch.Tensor) -> torch.Tensor:
    return v.var() / (v.mean() ** 2 + 1e-10)


class _Attn(nn.Module):
    def __init__(self, dim, heads, ws):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("index", torch.as_tensor(position_index(ws)),
                             persistent=False)

    def forward(self, x, mask):
        B, Hp, Wp, C = x.shape
        ws, H = self.ws, self.heads
        N, hd = ws * ws, C // H
        qkv = windows(dense(x, self.qkv), ws)
        Bn = qkv.shape[0]
        q, k, v = qkv.reshape(Bn, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        a = mm(q * hd ** -0.5, k.transpose(-1, -2))
        a = a + self.relative_position_bias_table[self.index].reshape(
            N, N, H).permute(2, 0, 1)
        if mask is not None:
            nW = mask.shape[0]
            a = (a.reshape(Bn // nW, nW, H, N, N) + mask[None, :, None]
                 ).reshape(Bn, H, N, N)
        out = mm(torch.softmax(a, -1), v).permute(0, 2, 1, 3).reshape(Bn, N,
                                                                       C)
        return dense(unwindows(out, ws, Hp, Wp), self.proj)


class _Mlp(nn.Module):
    def __init__(self, dim, hidden, fc2_bias):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim, bias=fc2_bias)

    def forward(self, x, draws, routes):
        return dense(gelu(dense(x, self.fc1)), self.fc2), None


class _MoE(nn.Module):
    def __init__(self, dim, hidden, experts, moe):
        super().__init__()
        self.E, self.cfg = experts, moe
        self.gate = nn.Parameter(torch.zeros(dim, experts))
        self.w1 = nn.Parameter(torch.zeros(experts, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(experts, 1, hidden))
        self.w2 = nn.Parameter(torch.zeros(experts, hidden, dim))
        self.b2 = (nn.Parameter(torch.zeros(experts, 1, dim))
                   if moe["fc2_bias"] else None)

    def capacity(self, T: int) -> int:
        return max(int(self.cfg["capacity_factor"] * T / self.E), 1)

    def route(self, g: torch.Tensor, e: torch.Tensor, C: int):
        """(slot [T], keep [T]) in the priority order."""
        T = e.shape[0]
        order = (torch.sort(g, descending=True, stable=True).indices
                 if self.cfg["bpr"] else torch.arange(T, device=e.device))
        slot = torch.empty(T, dtype=torch.long, device=e.device)
        es = e[order]
        for x in range(self.E):
            mine = order[es == x]
            slot[mine] = torch.arange(len(mine), device=e.device)
        return slot, slot < C

    def forward(self, x, draws, routes: Optional[List]):
        """x [B, L, D] → (y, aux); ``draws``: (noise [T, E] or None,
        dropout keep-mask [E, C, Hd] or None)."""
        B, L, D = x.shape
        m, E = self.cfg, self.E
        t = x.reshape(B * L, D)
        T = t.shape[0]
        C = self.capacity(T)
        logits = mm(t, self.gate)
        noise, drop = draws
        noisy = logits if noise is None else (
            logits + noise * m["gate_noise"] / E)
        scores = torch.softmax(noisy, -1)
        e = torch.argmax(scores, -1)
        g = scores.gather(1, e[:, None])[:, 0]
        if m["gshard_loss"]:
            first = nn.functional.one_hot(e, E).to(scores.dtype)
            aux = E * (scores.mean(0) * first.mean(0)).sum()
        else:
            p = torch.softmax(logits, -1)
            theta = noisy.gather(1, e[:, None])
            load = torch.special.ndtr((p - theta) / (m["gate_noise"] / E))
            aux = 0.5 * (cv_squared(p.sum(0)) + cv_squared(load.sum(0)))
        slot, keep = self.route(g.detach(), e, C)
        if routes is not None:
            routes.append((e.detach(), keep.detach(), E * C))
        kept = torch.nonzero(keep)[:, 0]
        xe = t.new_zeros(E, C, D).index_put((e[kept], slot[kept]), t[kept])
        h = gelu(mm(xe, self.w1) + self.b1)
        h = keep_apply(h, drop, m["drop"])
        ye = mm(h, self.w2)
        if self.b2 is not None:
            ye = ye + self.b2
        y = t.new_zeros(T, D).index_put(
            (kept,), g[kept, None] * ye[e[kept], slot[kept]])
        return y.reshape(B, L, D), m["aux_weight"] * aux


class _Block(nn.Module):
    def __init__(self, dim, res, heads, ws, shift, ratio, experts, moe):
        super().__init__()
        if res <= ws:
            ws, shift = res, 0
        self.res, self.ws, self.shift = res, ws, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attn(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        hidden = int(dim * ratio)
        self.mlp = (_MoE(dim, hidden, experts, moe) if experts
                    else _Mlp(dim, hidden, moe["fc2_bias"]))
        m = shift_mask(res, res, ws, shift) if shift else None
        self.register_buffer("mask", None if m is None else torch.as_tensor(m),
                             persistent=False)

    def forward(self, x, d, routes=None):
        """``d``: the block's draws {"path": (keep [B], keep [B], rate) or
        None, "moe": (noise, keep) or None}."""
        B, L, C = x.shape
        r, s = self.res, self.shift
        y = _ln(x, self.norm1).reshape(B, r, r, C)
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = self.attn(y, self.mask)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + _drop_path(y.reshape(B, L, C), d["path"], 0)
        y, aux = self.mlp(_ln(x, self.norm2), d["moe"], routes)
        return x + _drop_path(y, d["path"], 1), aux


def _drop_path(x, drop, which):
    if drop is None:
        return x
    keep = drop[which].reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x / (1.0 - drop[2]), torch.zeros_like(x))


class _Merge(nn.Module):
    def __init__(self, res, dim):
        super().__init__()
        self.res = res
        self.norm = nn.LayerNorm(4 * dim, eps=1e-6)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, L, C = x.shape
        r = self.res
        x = x.reshape(B, r // 2, 2, r // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        x = torch.cat([x[:, :, :, 0, 0], x[:, :, :, 0, 1], x[:, :, :, 1, 0],
                       x[:, :, :, 1, 1]], -1).reshape(B, L // 4, 4 * C)
        return mm(_ln(x, self.norm), self.reduction.weight.t())


class _Stage(nn.Module):
    def __init__(self, blocks, down):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = down


class _PatchEmbed(nn.Module):
    def __init__(self, patch, chans, dim):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(chans, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        B, S, _, Ci = x.shape
        p = self.patch
        x = x.reshape(B, S // p, p, S // p, p, Ci).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, (S // p) ** 2, Ci * p * p)
        w = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        return _ln(mm(x, w.t()) + self.proj.bias, self.norm)


class SwinMoE(nn.Module):
    """``forward(x NHWC, draws, routes, remat)`` → (logits, Σ aux).
    ``swin``: img, patch, chans, embed, depths, heads, window, mlp_ratio,
    drop_path_rate; ``moe``: blocks (per stage, [-1] for none), experts,
    capacity_factor, gate_noise, aux_weight, drop, bpr, gshard_loss,
    fc2_bias (the experts' and the dense MLPs')."""

    def __init__(self, swin: Dict, moe: Dict, num_classes: int):
        super().__init__()
        s = swin
        self.depths, self.rate = tuple(s["depths"]), s["drop_path_rate"]
        self.patch_embed = _PatchEmbed(s["patch"], s["chans"], s["embed"])
        res = s["img"] // s["patch"]
        stages = []
        for i, d in enumerate(s["depths"]):
            dim, r = s["embed"] * 2 ** i, res // 2 ** i
            blocks = [_Block(dim, r, s["heads"][i], s["window"],
                             0 if j % 2 == 0 else s["window"] // 2,
                             s["mlp_ratio"],
                             moe["experts"] if j in moe["blocks"][i] else 0,
                             moe)
                      for j in range(d)]
            stages.append(_Stage(blocks, _Merge(r, dim)
                                 if i < len(s["depths"]) - 1 else None))
        self.layers = nn.ModuleList(stages)
        nf = s["embed"] * 2 ** (len(s["depths"]) - 1)
        self.norm = nn.LayerNorm(nf, eps=1e-6)
        self.head = nn.Linear(nf, num_classes)

    def blocks(self):
        return [b for st in self.layers for b in st.blocks]

    def rates(self) -> List[float]:
        return np.linspace(0, self.rate, sum(self.depths)).tolist()

    def forward(self, x, draws: Optional[Sequence] = None,
                routes: Optional[List] = None, remat: bool = False):
        """``routes``: a list that takes (choice [T], keep [T], E·C) of
        each MoE layer (not under ``remat``)."""
        x = self.patch_embed(x)
        aux = x.new_zeros(())
        i = 0
        for stage in self.layers:
            for blk in stage.blocks:
                d = (draws[i] if draws is not None
                     else {"path": None, "moe": (None, None)})
                if remat:         # the block's activations recomputed
                    x, a = torch.utils.checkpoint.checkpoint(
                        blk, x, d, use_reentrant=False)
                else:
                    x, a = blk(x, d, routes)
                if a is not None:
                    aux = aux + a
                i += 1
            if stage.downsample is not None:
                x = stage.downsample(x)
        x = _ln(x, self.norm).mean(1)
        return dense(x, self.head), aux


def draw_masks(model: SwinMoE, B: int, gen, device) -> List[Dict]:
    """One training forward's draws, block by block in the trainer's
    order: the attention half's DropPath keep-mask [B], the MoE's gate
    noise [T, E] and its dropout keep-mask [E, C, Hd], the MLP half's
    DropPath keep-mask [B] (a zero rate draws nothing)."""
    out = []
    for blk, rate in zip(model.blocks(), model.rates()):
        first = (torch.rand((B,), generator=gen, device=device) < 1.0 - rate
                 if rate > 0 else None)
        moe = (None, None)
        if isinstance(blk.mlp, _MoE):
            m, E = blk.mlp.cfg, blk.mlp.E
            T = B * blk.res * blk.res
            noise = (torch.randn((T, E), generator=gen, device=device)
                     if m["gate_noise"] > 0 else None)
            drop = None
            if m["drop"] > 0:
                shape = (E, blk.mlp.capacity(T), blk.mlp.w1.shape[-1])
                drop = (torch.rand(shape, generator=gen, device=device)
                        < 1.0 - m["drop"])
            moe = (noise, drop)
        second = (torch.rand((B,), generator=gen, device=device) < 1.0 - rate
                  if rate > 0 else None)
        out.append({"path": (first, second, rate) if rate > 0 else None,
                    "moe": moe})
    return out


def routing_counts(routes) -> Dict[str, int]:
    """{"routed", "kept", "slots"} of recorded routes: assignments, kept
    assignments and capacity slots E·C, summed over layers."""
    return {"routed": sum(int(e.numel()) for e, _, _ in routes),
            "kept": sum(int(k.sum()) for _, k, _ in routes),
            "slots": sum(n for _, _, n in routes)}
