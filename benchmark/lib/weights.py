"""Seeded model weights, made on the device in one draw and keyed by name.

Both sides of a comparison take their weights from ``make``: the system
under test copies them into its parameters, the reference loads them into
its own. The values depend only on the seed and on the (name, shape) list
sorted by name:

* ``logit_scale``: log 10 (SwinV2's initial value);
* embedding tables (a name holding ``embeddings``): N(0, 0.02²);
* ``attn_l`` / ``attn_r`` (GAT attention vectors): N(0, 1/width);
* other ≥2-d tensors (dense and convolution kernels): N(0, 1/fan_in);
* the BatchNorm scale that closes an Rs-GCN block's residual branch
  (``…W.1.weight``): 0, the block's published zero initialisation (the
  block starts as the identity; random scales make the eight blocks'
  affinity products grow without bound under running statistics);
* other 1-d ``…weight`` (LayerNorm and BatchNorm scales): 1 + N(0, 0.1²);
* other 1-d tensors (biases): N(0, 0.02²).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...]]]


def spec_of(named: Iterable[Tuple[str, torch.Tensor]]) -> Spec:
    return sorted((k, tuple(p.shape)) for k, p in named)


def _scale_shift(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    if name.endswith("logit_scale"):
        return 0.0, math.log(10.0)
    if "embeddings" in name:
        return 0.02, 0.0
    if name.endswith("attn_l") or name.endswith("attn_r"):
        return 1.0 / math.sqrt(shape[-1]), 0.0
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if name.endswith("W.1.weight"):
        return 0.0, 0.0
    if name.endswith("weight"):
        return 0.1, 1.0
    return 0.02, 0.0


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor} for every entry of ``spec``, from one normal
    draw of a generator on ``device`` seeded ``seed``."""
    total = sum(math.prod(s) for _, s in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        scale, shift = _scale_shift(name, shape)
        t = flat[off:off + n].view(shape)
        t.mul_(scale).add_(shift)
        out[name] = t
        off += n
    return out


@torch.no_grad()
def load(module: torch.nn.Module, table: Dict[str, torch.Tensor]) -> None:
    """Copy the table into ``module``'s parameters (names must match)."""
    named = dict(module.named_parameters())
    if set(named) != set(table):
        missing = sorted(set(named) ^ set(table))[:8]
        raise KeyError(f"parameter names differ from the table: {missing}")
    for k, p in named.items():
        p.copy_(table[k])
