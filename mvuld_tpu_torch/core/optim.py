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

The step state lives on the device, so that a CUDA graph of the update
(``core/train_state.make_multi_train_step``) replays it: the inner step
count and the micro-step are device integers, the learning rate is read
from the schedule's fp32 table (``core/schedule.lr_table``) at the clamped
count, the bias corrections are ``torch.pow`` of fp32 betas on the count
(optax's fp32 arithmetic), and MultiSteps' "emit every k-th call" gates
the update's coefficients on the device: a call that does not emit runs
the update with b1 = b2 = 1, (1 − b1) = (1 − b2) = lr = 0, which leaves
the moments and parameters exactly as they are. The eager step runs the
same code. Each operation is one ``torch._foreach_*`` call over a
device's parameters (a few launches, not one per tensor).
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
    """√Σ‖t‖² in fp32 (optax.global_norm), on the first tensor's device
    (a pipeline's stages may hold theirs on others)."""
    dev = tensors[0].device
    return torch.sqrt(sum((t.float() * t.float()).sum().to(dev)
                          for t in tensors))


def _clip_scale(max_norm: float, norm: torch.Tensor) -> torch.Tensor:
    """optax.clip_by_global_norm's factor: 1 below ``max_norm``, else
    max_norm / ‖g‖."""
    return torch.where(norm < max_norm, torch.ones_like(norm),
                       max_norm / norm)


class Optimizer:
    """optax.chain(clip_by_global_norm, adamw | sgd) [inside MultiSteps]
    over ``params`` (a list of (name, parameter)); ``clip=None`` leaves the
    clip out (``train_east``'s optax.adam). ``update(grads)``
    changes the parameters in place; ``count_t`` is optax's step count of
    the inner optimizer (the schedule's argument) and ``mini_step_t``
    MultiSteps' micro-step, both device int64 scalars (``count`` and
    ``mini_step`` read them on the host). ``norm`` computes the
    global norm that the clip reads (``parallel.mesh.tp_global_norm``
    under tensor parallelism)."""

    def __init__(self, params: List[Tuple[str, torch.Tensor]],
                 decay: Dict[str, bool], schedule: Callable[[int], float],
                 name: str = "adamw", betas=(0.9, 0.999), eps: float = 1e-8,
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 clip: Optional[float] = 5.0, accumulation_steps: int = 1):
        from mvuld_tpu_torch.core.schedule import lr_table

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
        self.norm: Callable[[Sequence[torch.Tensor]], torch.Tensor] = \
            global_norm
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.mu = zeros()
        self.nu = zeros() if name == "adamw" else []
        self.acc = zeros() if self.k > 1 else []
        dev = self.params[0].device
        self.lrs = lr_table(schedule).to(dev)
        self.betas_t = torch.tensor(betas, dtype=torch.float32, device=dev)
        # the update's fp32 coefficients (the values of optax's Python
        # floats), gated on the device under MultiSteps
        self.consts = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                       for k, v in (("b1", self.b1), ("omb1", 1 - self.b1),
                                    ("b2", self.b2), ("omb2", 1 - self.b2),
                                    ("mu", momentum), ("one", 1.0),
                                    ("zero", 0.0))}
        self.count_t = torch.zeros((), dtype=torch.int64, device=dev)
        self.mini_step_t = torch.zeros((), dtype=torch.int64, device=dev)

    @property
    def count(self) -> int:
        return int(self.count_t)         # syncs

    @property
    def mini_step(self) -> int:
        return int(self.mini_step_t)     # syncs

    def _follow_params(self) -> None:
        """The step state on the parameters' device (a model moved after
        the optimizer was built); before any capture, at the first step."""
        dev = self.params[0].device
        if self.count_t.device != dev:
            for key in ("lrs", "betas_t", "count_t", "mini_step_t"):
                setattr(self, key, getattr(self, key).to(dev))
            self.consts = {k: t.to(dev) for k, t in self.consts.items()}

    def _groups(self) -> List[Tuple[torch.device, List[int]]]:
        """The parameters' indices by device (a pipeline's stages hold
        theirs on several): each group's lists go through one ``_foreach``
        call per operation."""
        by_dev: Dict[torch.device, List[int]] = {}
        for i, p in enumerate(self.params):
            by_dev.setdefault(p.device, []).append(i)
        return list(by_dev.items())

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        self._follow_params()
        grads = [g.float() for g in grads]
        c = self.consts
        scal = _Scalars()
        groups = self._groups()
        emit = None                 # MultiSteps: True on every k-th call
        if self.k > 1:
            n1 = self.mini_step_t + 1
            emit = n1 == self.k
            self.mini_step_t.copy_(torch.where(emit, 0, n1))
            scal.add(inv=1.0 / n1.float(), keep=(~emit).float())
            for dev, idx in groups:
                acc = [self.acc[i] for i in idx]
                d = torch._foreach_sub([grads[i] for i in idx], acc)
                torch._foreach_mul_(d, scal.on(dev)["inv"])
                torch._foreach_add_(acc, d)
            grads = self.acc
        if self.clip is not None:
            scal.add(clip=_clip_scale(self.clip, self.norm(grads)))
        lr = torch.take(self.lrs, self.count_t.clamp(max=len(self.lrs) - 1))
        self.count_t.add_(1 if emit is None else emit.long())
        # the bias corrections at count ≥ 1: a MultiSteps call before the
        # first emit runs the update with weight 0 and must not divide by
        # 1 − β⁰ = 0
        corr = 1 - torch.pow(self.betas_t,
                             self.count_t.clamp(min=1).float())

        def gate(on, off):
            """``on``; under MultiSteps ``off`` on a call that does not
            emit, which leaves the moments and parameters as they are."""
            return on if emit is None else torch.where(emit, on, off)

        scal.add(neg_lr=gate(-lr, c["zero"]), c1=corr[0], c2=corr[1])
        if self.name == "adamw":
            scal.add(b1=gate(c["b1"], c["one"]), omb1=gate(c["omb1"], c["zero"]),
                     b2=gate(c["b2"], c["one"]), omb2=gate(c["omb2"], c["zero"]))
        else:
            scal.add(mu=gate(c["mu"], c["one"]), g=gate(c["one"], c["zero"]))
        for dev, idx in groups:
            self._update_group(dev, idx, grads, scal.on(dev))
            if emit is not None:
                torch._foreach_mul_([self.acc[i] for i in idx],
                                    scal.on(dev)["keep"])

    def _update_group(self, dev, idx: List[int], grads: List[torch.Tensor],
                      s: Dict[str, torch.Tensor]) -> None:
        """The clip and the inner step on one device's parameters, in
        optax's arithmetic: m = b1·m + (1−b1)·g, v = b2·v + (1−b2)·g²,
        p += −lr·(m/c1 / (√(v/c2) + eps) + wd·p) (AdamW); t = μ·t + g,
        p += −lr·(g + μ·t) with g += wd·p first (SGD). The coefficients are
        device scalars (gated under MultiSteps)."""
        ps = [self.params[i] for i in idx]
        gs = [grads[i] for i in idx]
        if "clip" in s:
            gs = torch._foreach_mul(gs, s["clip"])
        dec = [j for j, i in enumerate(idx) if self.decay[i]]
        wd = self.weight_decay
        if self.name == "adamw":
            ms = [self.mu[i] for i in idx]
            vs = [self.nu[i] for i in idx]
            torch._foreach_mul_(ms, s["b1"])
            torch._foreach_add_(ms, torch._foreach_mul(gs, s["omb1"]))
            sq = torch._foreach_mul(gs, gs)
            torch._foreach_mul_(sq, s["omb2"])
            torch._foreach_mul_(vs, s["b2"])
            torch._foreach_add_(vs, sq)
            del sq
            den = torch._foreach_div(vs, s["c2"])
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(ms, s["c1"])
            torch._foreach_div_(upd, den)
            del den
            if dec:
                torch._foreach_add_([upd[j] for j in dec],
                                    [ps[j] for j in dec], alpha=wd)
        else:
            ts = [self.mu[i] for i in idx]
            if dec:
                gs = list(gs)
                for j, g in zip(dec, torch._foreach_add(
                        [gs[j] for j in dec], [ps[j] for j in dec],
                        alpha=wd)):
                    gs[j] = g
            torch._foreach_mul_(ts, s["mu"])
            torch._foreach_add_(ts, torch._foreach_mul(gs, s["g"]))
            upd = torch._foreach_mul(ts, self.momentum)
            torch._foreach_add_(upd, gs)
        torch._foreach_mul_(upd, s["neg_lr"])
        torch._foreach_add_(ps, upd)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    def load_state_dict(self, state: Dict) -> None:
        self.count_t.fill_(int(state["count"]))
        self.mini_step_t.fill_(int(state["mini_step"]))
        for key in ("mu", "nu", "acc"):
            for dst, src in zip(getattr(self, key), state[key]):
                dst.copy_(src)


class _Scalars:
    """One update's device scalars by name, copied once to each device the
    parameters hold (a pipeline's stages)."""

    def __init__(self):
        self._by_dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self._first: Dict[str, torch.Tensor] = {}

    def add(self, **scalars: torch.Tensor) -> None:
        self._first.update(scalars)
        self._by_dev.clear()

    def on(self, dev) -> Dict[str, torch.Tensor]:
        if dev not in self._by_dev:
            self._by_dev[dev] = {k: t.to(dev) for k, t in self._first.items()}
        return self._by_dev[dev]


def build_optimizer(cfg, schedule: Callable[[int], float],
                    model: nn.Module) -> Optimizer:
    t = cfg.TRAIN
    return Optimizer(
        list(model.named_parameters()), decay_mask(model), schedule,
        name=t.OPTIMIZER.NAME.lower(), betas=tuple(t.OPTIMIZER.BETAS),
        eps=t.OPTIMIZER.EPS, momentum=t.OPTIMIZER.MOMENTUM,
        weight_decay=t.WEIGHT_DECAY, clip=t.CLIP_GRAD,
        accumulation_steps=t.ACCUMULATION_STEPS)
