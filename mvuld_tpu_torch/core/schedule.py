"""LR schedules — step-level cosine/linear/step with warmup.

Counterpart of ``mvuld_tpu/core/schedule.py`` (reference
mvuld/lr_scheduler.py:13-105, timm schedulers stepped per STEP), written
out as optax computes them: a linear warmup from WARMUP_LR to the base LR
over ``warmup_steps``, joined at ``warmup_steps`` (``join_schedules``: the
second schedule sees ``step − warmup_steps``) to cosine, linear or
staircase exponential decay; plus the linear LR scaling rule applied at
startup (BASE_LR × batch/512, mvuld/main.py:486-493). A schedule is a
function of the optimizer's step count returning a float; its
``total_steps`` attribute is the count from which it no longer changes
(the staircase decay goes on stepping; training never counts past its
total).

``lr_table`` tabulates a schedule as fp32 rates, the optimizer's device
copy (``core/optim.py``): one rate per count up to ``total_steps``, read at
the clamped count on the device, so a CUDA graph replays the schedule
(optax evaluates the schedule in fp32 too).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

TABLE_STEPS = 1 << 16     # counts tabulated of a schedule without a total


def _total(fn: Callable, total_steps: int) -> Callable:
    fn.total_steps = total_steps
    return fn


def lr_table(schedule: Callable[[int], float]) -> torch.Tensor:
    """fp32 [n + 1]: ``schedule(count)`` for counts 0..n, n its
    ``total_steps`` (TABLE_STEPS − 1 for a callable without one)."""
    n = getattr(schedule, "total_steps", TABLE_STEPS - 1)
    return torch.tensor([schedule(i) for i in range(max(n, 0) + 1)],
                        dtype=torch.float32)


def scale_lr(base_lr: float, global_batch: int, denom: int = 512) -> float:
    return base_lr * global_batch / denom


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init → end over ``steps``, then end."""
    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _join(first: Callable, second: Callable, boundary: int
          ) -> Callable[[int], float]:
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def cosine_schedule(base_lr: float, warmup_lr: float, min_lr: float,
                    warmup_steps: int, total_steps: int) -> Callable:
    decay_steps = max(total_steps - warmup_steps, 1)
    alpha = min_lr / base_lr if base_lr > 0 else 0.0

    def cosine(count: int) -> float:      # optax.cosine_decay_schedule
        frac = min(count, decay_steps) / decay_steps
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha
        return base_lr * decayed

    return _total(_join(_linear(warmup_lr, base_lr, max(warmup_steps, 1)),
                        cosine, warmup_steps), max(total_steps, warmup_steps + 1))


def linear_schedule(base_lr: float, warmup_lr: float, min_lr: float,
                    warmup_steps: int, total_steps: int) -> Callable:
    return _total(_join(
        _linear(warmup_lr, base_lr, max(warmup_steps, 1)),
        _linear(base_lr, min_lr, max(total_steps - warmup_steps, 1)),
        warmup_steps), max(total_steps, warmup_steps + 1))


def step_schedule(base_lr: float, warmup_lr: float, min_lr: float,
                  warmup_steps: int, total_steps: int, decay_steps: int = 0,
                  decay_rate: float = 0.1) -> Callable:
    every = max(decay_steps, 1)

    def step(count: int) -> float:        # optax.exponential_decay, staircase
        return base_lr * decay_rate ** (count // every)

    return _total(_join(_linear(warmup_lr, base_lr, max(warmup_steps, 1)),
                        step, warmup_steps), max(total_steps, warmup_steps + 1))


SCHEDULERS = {"cosine": cosine_schedule, "linear": linear_schedule,
              "step": step_schedule}


def build_schedule(cfg, steps_per_epoch: int, global_batch: int) -> Callable:
    """The schedule TRAIN.LR_SCHEDULER.NAME selects, with the reference's
    epoch→step conversion and LR scaling."""
    t = cfg.TRAIN
    base = scale_lr(t.BASE_LR, global_batch)
    warmup = scale_lr(t.WARMUP_LR, global_batch)
    minimum = scale_lr(t.MIN_LR, global_batch)
    warmup_steps = t.WARMUP_EPOCHS * steps_per_epoch
    total_steps = t.EPOCHS * steps_per_epoch
    name = t.LR_SCHEDULER.NAME
    if name not in SCHEDULERS:
        raise KeyError(f"unknown LR scheduler {name!r}")
    kwargs = {}
    if name == "step":
        kwargs = {"decay_steps": t.LR_SCHEDULER.DECAY_EPOCHS * steps_per_epoch,
                  "decay_rate": t.LR_SCHEDULER.DECAY_RATE}
    return SCHEDULERS[name](base, warmup, minimum, warmup_steps, total_steps,
                            **kwargs)
