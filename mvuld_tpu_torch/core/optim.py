"""Optimizer with the reference's weight-decay policy, as optax computes it.

Counterpart of ``mvuld_tpu/core/optim.py`` (reference mvuld/optimizer.py
:11-59): AdamW (default) or SGD with Nesterov momentum; no weight decay for
1-d parameters or parameters whose JAX path holds one of
``NO_DECAY_KEYWORDS``; gradients clipped by global norm (TRAIN.CLIP_GRAD)
and accumulated over TRAIN.ACCUMULATION_STEPS micro-steps. Each rule is
optax's arithmetic, written out over lists of tensors and updated in place:

  clip_by_global_norm  g if ‖g‖ < c else g / ‖g‖ · c   (not torch's
                       clip_grad_norm_, whose divisor is ‖g‖ + 1e-6)
  adamw                m = b1·m + (1−b1)·g, v = b2·v + (1−b2)·g²,
                       u = m̂ / (√v̂ + eps) + wd·p (decayed params),
                       p −= lr(step)·u
  sgd (nesterov)       g += wd·p (decayed), t = g + μ·t, p −= lr·(g + μ·t)
  MultiSteps           the running mean of k micro-step gradients reaches
                       the inner update on every k-th call; the others
                       leave the parameters as they are

The decay decision is taken on the JAX name of each parameter
(``models/convert.py`` ``torch_to_jax_names``): torch names such as
``...norm.weight`` would decide differently.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

NO_DECAY_KEYWORDS = ("cpb_fc", "logit_scale", "relative_position_bias_table",
                     "bn", "norm", "scale", "bias", "embedding")


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True where weight decay applies}: ≥2-d parameters
    whose ``/``-joined JAX path (under ``params/``) holds no keyword."""
    from mvuld_tpu_torch.models.convert import torch_to_jax_names

    names = torch_to_jax_names(model)
    out = {}
    for name, p in model.named_parameters():
        path = names[name].partition("/")[2].lower()
        out[name] = p.dim() > 1 and not any(k in path for k in
                                            NO_DECAY_KEYWORDS)
    return out


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√Σ‖t‖² in fp32 (optax.global_norm)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> List[torch.Tensor]:
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return [g * scale.to(g.dtype) for g in grads]


class Optimizer:
    """optax.chain(clip_by_global_norm, adamw | sgd) [inside MultiSteps]
    over ``params`` (a list of (name, parameter)); ``clip=None`` leaves the
    clip out (``train_east``'s optax.adam). ``update(grads)``
    changes the parameters in place; ``count`` is optax's step count of the
    inner optimizer (the schedule's argument)."""

    def __init__(self, params: List[Tuple[str, torch.Tensor]],
                 decay: Dict[str, bool], schedule: Callable[[int], float],
                 name: str = "adamw", betas=(0.9, 0.999), eps: float = 1e-8,
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 clip: Optional[float] = 5.0, accumulation_steps: int = 1):
        if name not in ("adamw", "sgd"):
            raise ValueError(f"Unknown optimizer {name!r}")
        self.names = [n for n, _ in params]
        self.params = [p for _, p in params]
        self.decay = [decay[n] for n in self.names]
        self.schedule, self.name = schedule, name
        self.b1, self.b2 = betas
        self.eps, self.momentum = eps, momentum
        self.weight_decay, self.clip = weight_decay, clip
        self.k = accumulation_steps
        self.count = 0
        self.mini_step = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.mu = zeros()
        self.nu = zeros() if name == "adamw" else []
        self.acc = zeros() if self.k > 1 else []

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        grads = [g.float() for g in grads]
        if self.k > 1:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.k
            if self.mini_step != 0:
                return
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.clip is not None:
            grads = clip_by_global_norm(grads, self.clip, global_norm(grads))
        lr = self.schedule(self.count)
        self.count += 1
        wd = self.weight_decay
        if self.name == "adamw":
            c1 = 1 - self.b1 ** self.count
            c2 = 1 - self.b2 ** self.count
            for p, g, m, v, dec in zip(self.params, grads, self.mu, self.nu,
                                       self.decay):
                m.mul_(self.b1).add_(g, alpha=1 - self.b1)
                v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
                u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
                if dec:
                    u = u + wd * p
                p.add_(u, alpha=-lr)
        else:
            mu = self.momentum
            for p, g, t, dec in zip(self.params, grads, self.mu, self.decay):
                if dec:
                    g = g + wd * p
                t.mul_(mu).add_(g)
                p.add_(g + mu * t, alpha=-lr)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    def load_state_dict(self, state: Dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for key in ("mu", "nu", "acc"):
            for dst, src in zip(getattr(self, key), state[key]):
                dst.copy_(src)


def build_optimizer(cfg, schedule: Callable[[int], float],
                    model: nn.Module) -> Optimizer:
    t = cfg.TRAIN
    return Optimizer(
        list(model.named_parameters()), decay_mask(model), schedule,
        name=t.OPTIMIZER.NAME.lower(), betas=tuple(t.OPTIMIZER.BETAS),
        eps=t.OPTIMIZER.EPS, momentum=t.OPTIMIZER.MOMENTUM,
        weight_decay=t.WEIGHT_DECAY, clip=t.CLIP_GRAD,
        accumulation_steps=t.ACCUMULATION_STEPS)
