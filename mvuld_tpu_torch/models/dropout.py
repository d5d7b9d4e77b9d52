"""Dropout and stochastic-depth masks drawn from an explicit generator.

Training draws every mask from the ``torch.Generator`` the train step
passes down (flax draws from its "dropout" rng collection); ``gen=None``
or a zero rate leaves the tensor as it is. Masks are uniform draws below
the keep probability, so two models that draw the same shapes in the same
order from equally seeded generators drop the same elements (the kernel
and plain paths of ``chip_smoke.py`` rely on it).

A mask's rows may be cut from a larger draw. Two wrappers stand in for
the generator and say how; ``draw_rows`` composes them:

* ``DPGenerator`` (data parallelism). The JAX package draws a dp batch's
  masks from one key over the global batch. A dp rank's step generator is
  seeded as rank 0's; a draw of (rows, ...) takes (dp · rows, ...) and
  keeps rows [rank · rows, (rank + 1) · rows). ``shard_batch`` gives a
  rank a contiguous block of every column's rows and the masks are
  batch-major (window rows included: windows are partitioned image by
  image), so the ranks' masks concatenated are one rank's mask.
* ``SlotRows`` (packed rows). The e2e model encodes the valid code lines
  packed into fewer rows; their masks are drawn over every line slot and
  the packed lines' rows gathered, so the masks follow the lines, not
  their places in the pack (which differ between one rank and dp ranks).

Activation checkpointing: a ``StageRng`` stands in for the generator in a
checkpointed stage so that the recomputation drops what the first run
dropped. It rewinds the generator; inside a CUDA graph capture, where a
generator's state can be neither read nor set, it keeps the first run's
masks instead.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch


class DPGenerator:
    """The step generator of dp rank ``rank`` of ``size``: ``gen`` seeded
    as every rank's, its draws taken over the global batch."""

    def __init__(self, gen: torch.Generator, size: int, rank: int):
        self.gen, self.size, self.rank = gen, size, rank

    @property
    def device(self) -> torch.device:
        return self.gen.device


class SlotRows:
    """``gen`` for a batch of rows picked from ``slots`` rows: a draw of
    (n, ...) takes (slots, ...) and keeps the rows ``pick`` (n indices)."""

    def __init__(self, gen, slots: int, pick: torch.Tensor):
        self.gen, self.slots, self.pick = gen, slots, pick

    @property
    def device(self) -> torch.device:
        return self.gen.device


def rank_generator(device, seed: int, dp_size: int = 1, dp_rank: int = 0):
    """The step generator of a dp rank: seeded ``seed`` on every rank, its
    draws taken over the global batch (module docstring)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return gen if dp_size == 1 else DPGenerator(gen, dp_size, dp_rank)


def base_generator(gen) -> torch.Generator:
    """The ``torch.Generator`` under the wrappers."""
    while not isinstance(gen, torch.Generator):
        gen = gen.gen
    return gen


def draw_rows(fn: Callable, shape: Sequence[int], gen, device, **kw
              ) -> torch.Tensor:
    """``fn(shape, generator=..., device=device)`` (``torch.rand``,
    ``torch.randn``), cut from the larger draw the wrappers describe."""
    shape = tuple(shape)
    if isinstance(gen, StageRng):
        return gen.replayed(lambda g: draw_rows(fn, shape, g, device, **kw))
    if isinstance(gen, SlotRows):
        if len(gen.pick) != shape[0]:
            raise ValueError(f"a draw of {shape[0]} rows from "
                             f"{len(gen.pick)} picked slots")
        full = draw_rows(fn, (gen.slots,) + shape[1:], gen.gen, device, **kw)
        return full[gen.pick]
    if isinstance(gen, DPGenerator):
        n = shape[0]
        full = fn((gen.size * n,) + shape[1:], generator=gen.gen,
                  device=device, **kw)
        return full[gen.rank * n:(gen.rank + 1) * n]
    return fn(shape, generator=gen, device=device, **kw)


class StageRng:
    """The generator of a checkpointed stage. ``run(fn, *args)`` calls
    ``fn(*args, self)``; the first run draws from ``gen``, a later run (the
    recomputation) draws the same masks. Outside a CUDA graph capture the
    later run rewinds the generator to the stage's start and puts it back
    after, so nothing is held. Inside a capture a generator's state can be
    neither read nor set (torch 2.11 refuses ``clone_state`` there, and its
    ``get_state`` omits the capture's offset): the first run keeps its
    masks and the later run returns them, in the same order."""

    def __init__(self, gen):
        self.gen = gen
        base = base_generator(gen)
        self.tape: Optional[List[torch.Tensor]] = (
            [] if base.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing() else None)
        self.start = base.get_state() if self.tape is None else None
        self.runs = 0
        self.pos: Optional[int] = None      # None: drawing

    def run(self, fn: Callable, *args):
        self.runs += 1
        if self.runs == 1:
            return fn(*args, self)
        if self.tape is not None:
            self.pos = 0
            return fn(*args, self)
        base = base_generator(self.gen)
        now = base.get_state()
        base.set_state(self.start)
        try:
            return fn(*args, self)
        finally:
            base.set_state(now)

    def replayed(self, draw: Callable) -> torch.Tensor:
        """``draw(gen)``; in a capture's later run, what the first run's
        draw at this place returned."""
        if self.pos is not None:
            out = self.tape[self.pos]
            self.pos += 1
            return out
        out = draw(self.gen)
        if self.tape is not None:
            self.tape.append(out)
        return out


def keep_mask(shape: Sequence[int], rate: float, gen, device
              ) -> torch.Tensor:
    """Boolean keep-mask: True with probability 1 − rate."""
    if isinstance(gen, StageRng):       # the boolean mask is what it keeps
        return gen.replayed(lambda g: keep_mask(shape, rate, g, device))
    return draw_rows(torch.rand, shape, gen, device) < 1.0 - rate


def apply_keep(x: torch.Tensor, mask: torch.Tensor, rate: float
               ) -> torch.Tensor:
    """flax ``Dropout``: kept elements divided by keep in x's dtype."""
    return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    if gen is None or rate == 0.0:
        return x
    return apply_keep(x, keep_mask(x.shape, rate, gen, x.device), rate)
