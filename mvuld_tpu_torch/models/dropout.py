"""Dropout and stochastic-depth masks drawn from an explicit generator.

Training draws every mask from the ``torch.Generator`` the train step
passes down (flax draws from its "dropout" rng collection); ``gen=None``
or a zero rate leaves the tensor as it is. Masks are uniform draws below
the keep probability, so two models that draw the same shapes in the same
order from equally seeded generators drop the same elements (the kernel
and plain paths of ``chip_smoke.py`` rely on it).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def keep_mask(shape: Sequence[int], rate: float, gen: torch.Generator,
              device) -> torch.Tensor:
    """Boolean keep-mask: True with probability 1 − rate."""
    return torch.rand(tuple(shape), generator=gen, device=device) < 1.0 - rate


def apply_keep(x: torch.Tensor, mask: torch.Tensor, rate: float
               ) -> torch.Tensor:
    """flax ``Dropout``: kept elements divided by keep in x's dtype."""
    return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    if gen is None or rate == 0.0:
        return x
    return apply_keep(x, keep_mask(x.shape, rate, gen, x.device), rate)
