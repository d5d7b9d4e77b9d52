"""GPipe pipeline parallelism for the text encoder.

Counterpart of ``mvuld_tpu/parallel/pipeline.py``. The JAX package runs a
uniform layer stack partitioned over a "pp" mesh axis in one program
(``shard_map`` + ``ppermute`` inside ``lax.scan``), and ``jax.grad``
through it is the reverse schedule. The port keeps its single-controller
design: one process drives S stages over a list of devices, stage s on
``devices[s % len(devices)]`` (torchgpipe's layout), each stage's
activations moved to the next stage's device, and autograd through the
ticks gives the reverse schedule. On one card every stage sits on it.

Schedule (S stages, M microbatches, T = M+S−1 ticks)::

    tick t: stage s computes microbatch t − s when 0 ≤ t − s < M,
            then hands its activation to stage s + 1.

The last stage's outputs, microbatch order, are the result. Dropout keys
are JAX's rule: layer l of microbatch m draws from a generator seeded by
(seed, m, l) with l the global layer index, so masks do not depend on how
the stack is split into stages; the embedding dropout is keyed apart from
them. ``remat`` checkpoints each stage's run of layers (the JAX
``jax.checkpoint`` of the stage); the recomputation re-seeds the same
generators, so it drops the same elements.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

EMBED_KEY = 1 << 20          # the embedding dropout's layer index
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class PipelineMesh:
    """S stages over ``devices``: stage s runs on devices[s % len]."""

    stages: int
    devices: Sequence[torch.device]

    def device(self, stage: int) -> torch.device:
        return self.devices[stage % len(self.devices)]


def make_pp_mesh(n_stages: int, devices: Optional[Sequence] = None
                 ) -> PipelineMesh:
    """``n_stages`` stages over ``devices`` (by default every visible card,
    at most one per stage, else the CPU)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = ([torch.device("cuda", i) for i in range(min(n, n_stages))]
                   or [torch.device("cpu")])
    return PipelineMesh(n_stages, [torch.device(d) for d in devices])


def stack_layer_params(params: Mapping[str, torch.Tensor], num_layers: int,
                       prefix: str = "encoder.layer.") -> dict:
    """Per-layer tensors ``{prefix}{i}.{name}`` stacked into ``{name}: [L,
    …]`` — the layout the JAX pipeline shards over its stage axis.
    Differentiable (``torch.stack``)."""
    names = [k[len(f"{prefix}0."):] for k in params
             if k.startswith(f"{prefix}0.")]
    return {n: torch.stack([params[f"{prefix}{i}.{n}"]
                            for i in range(num_layers)]) for n in names}


def _layer_count(stacked) -> int:
    if isinstance(stacked, torch.Tensor):
        return stacked.shape[0]
    if isinstance(stacked, Mapping):
        return next(iter(stacked.values())).shape[0]
    return len(stacked)


def _layer(stacked, i: int):
    if isinstance(stacked, Mapping):
        return {k: v[i] for k, v in stacked.items()}
    return stacked[i]


def _check_split(layers: int, stages: int) -> None:
    if layers % stages != 0:
        raise ValueError(f"pipeline: {layers} layers must divide into "
                         f"{stages} stages")


def _mix(*xs: int) -> int:
    """A 63-bit seed from integers (splitmix64 steps)."""
    h = 0x9E3779B97F4A7C15
    for x in xs:
        h = (h ^ (x & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 29
    return h >> 1


def key_generator(seed: int, device, *path: int) -> torch.Generator:
    """The generator of the dropout drawn at ``path`` under ``seed``."""
    return torch.Generator(device=device).manual_seed(_mix(seed, *path))


def gpipe(layer_fn: Callable, stacked_params: Any, x: torch.Tensor,
          extras: Any, mesh: PipelineMesh, num_microbatches: int,
          remat: bool = False, rng: Optional[int] = None) -> torch.Tensor:
    """Run ``x`` [B, …] through L layers pipelined over ``mesh.stages``
    stages. ``layer_fn(layer_params, h, extras, key) -> h`` applies one
    layer; ``stacked_params`` is a tensor or a dict of tensors with a
    leading layer axis [L, …], or a sequence of L per-layer objects
    (modules). ``extras``: a tensor of per-example side inputs [B, …]
    (the attention bias) cut into the same microbatches, or None. ``rng``
    (an integer seed) enables stochastic layers: ``key`` is then the
    generator of (rng, microbatch, global layer index), else None."""
    S = mesh.stages
    L = _layer_count(stacked_params)
    _check_split(L, S)
    B, M = x.shape[0], num_microbatches
    if B % M != 0:
        raise ValueError(f"pipeline: batch {B} must be a multiple of the "
                         f"microbatch count {M}")
    Lp = L // S
    x_mb = x.chunk(M)
    extras_mb = [None] * M if extras is None else extras.chunk(M)

    def run_stage(s: int, mb: int, h, extra):
        for lid in range(s * Lp, (s + 1) * Lp):
            key = (None if rng is None
                   else key_generator(rng, h.device, mb, lid))
            h = layer_fn(_layer(stacked_params, lid), h, extra, key)
        return h

    acts: List[Optional[torch.Tensor]] = [None] * M   # mb's latest output
    for t in range(M + S - 1):
        for s in range(S):
            mb = t - s
            if not 0 <= mb < M:
                continue
            dev = mesh.device(s)
            h = (x_mb[mb] if s == 0 else acts[mb]).to(dev)
            extra = None if extras_mb[mb] is None else extras_mb[mb].to(dev)
            if remat and torch.is_grad_enabled():
                acts[mb] = checkpoint(run_stage, s, mb, h, extra,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                acts[mb] = run_stage(s, mb, h, extra)
    return torch.cat([a.to(x.device) for a in acts])


def roberta_pipeline_forward(encoder, input_ids: torch.Tensor,
                             attention_mask: Optional[torch.Tensor],
                             mesh: PipelineMesh, num_microbatches: int = 4,
                             remat: bool = False,
                             dropout_rng: Optional[int] = None
                             ) -> torch.Tensor:
    """The pipelined ``RobertaEncoder`` forward: the embeddings on the
    input's device, the layers pipelined over ``mesh``. Each layer is the
    sequential encoder's own ``TransformerLayer``, so without dropout the
    output equals the sequential encoder's. ``dropout_rng`` (an integer
    seed) enables train-mode dropout: the layers' by gpipe's per
    (microbatch, layer) keys, the embeddings' by the key (seed, 2^20)."""
    c = encoder.config
    if attention_mask is None:
        attention_mask = (input_ids != c.pad_token_id).long()
    gen = (None if dropout_rng is None or c.dropout_rate <= 0
           else key_generator(dropout_rng, input_ids.device, EMBED_KEY))
    hidden = encoder.embed(input_ids, gen)
    bias = encoder.attention_bias(attention_mask)

    def layer_fn(layer, h, b, key):
        return layer(h, b, key)

    return gpipe(layer_fn, encoder.encoder.layer, hidden, bias, mesh,
                 num_microbatches, remat=remat, rng=dropout_rng)


def place_stages(encoder, mesh: PipelineMesh) -> None:
    """Move each stage's layers of a ``RobertaEncoder`` to its device."""
    layers = encoder.encoder.layer
    _check_split(len(layers), mesh.stages)
    per = len(layers) // mesh.stages
    for i, layer in enumerate(layers):
        layer.to(mesh.device(i // per))
