"""Loss, the train and eval steps, and early stopping.

Counterpart of ``mvuld_tpu/core/train_state.py`` (reference
mvuld/main.py:251-426): one step is forward (``train=True``: dropout and
DropPath masks from the step's generator, BatchNorm statistics from the
batch and updated in place), cross-entropy with label smoothing or mixup's
soft targets, backward,
clip and the optimizer update. No loss scaling: bf16 activations with fp32
parameters, as in the JAX package. The JAX package's K-steps-per-dispatch
``make_multi_train_step`` amortises TPU dispatch and has no counterpart
here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mvuld_tpu_torch.core.optim import Optimizer


Inputs = Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]


def model_inputs(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The tri-modal model's keyword inputs from a device batch (token ids
    as int64, the edge bitmask as a boolean adjacency)."""
    return {"func_ids": batch["func_ids"].long(),
            "node_ids": batch["node_ids"].long(), "image": batch["image"],
            "pos": batch["pos"], "adj": batch["adj"] > 0,
            "node_mask": batch["node_mask"]}


def image_inputs(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The image model's input (``SwinTransformerV2``) from a device batch."""
    return {"x": batch["image"]}


def _logits(out):
    """A model's logits: its output, or the first of a tuple (the text
    classifier also returns its sentence embedding)."""
    return out[0] if isinstance(out, tuple) else out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0,
                  soft_targets: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Mean CE over fp32 log-softmax (fp64 logits stay fp64);
    ``soft_targets`` (mixup's) take the place of the integer labels, and
    smoothing mixes in the uniform distribution."""
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    if soft_targets is not None:
        targets = soft_targets.to(logp.dtype)
    else:
        targets = F.one_hot(labels.long(), num_classes).to(logp.dtype)
    if label_smoothing > 0:
        targets = targets * (1 - label_smoothing) + label_smoothing / num_classes
    return -(targets * logp).sum(-1).mean()


def train_step(model: nn.Module, opt: Optimizer, batch: Dict[str, torch.Tensor],
               gen: Optional[torch.Generator], label_smoothing: float = 0.1,
               inputs: Inputs = model_inputs, aux_loss: bool = False,
               mesh=None) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch`` (device tensors: what ``inputs``
    turns into the model's inputs, "label", and mixup's "soft_label" when
    present). ``aux_loss``: the model returns (logits, aux) and aux joins
    the loss (Swin-MoE's load-balancing loss). Returns the metrics loss,
    grad_norm (before clipping) and acc as device scalars, so the caller
    decides when to synchronise. ``mesh`` (``parallel/mesh.py``): the batch
    is this rank's block of the global batch; the gradients are averaged
    over dp before the clip, and loss and acc are the global batch's."""
    out = model(**inputs(batch), train=True, gen=gen)
    logits = _logits(out)
    loss = cross_entropy(logits, batch["label"], label_smoothing,
                         batch.get("soft_label"))
    if aux_loss:
        loss = loss + out[1]
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(opt.params, grads)]
    acc = (logits.argmax(-1) == batch["label"]).float().mean()
    loss = loss.detach()
    if mesh is not None:
        from mvuld_tpu_torch.parallel.mesh import (mean_over_dp,
                                                   reduce_gradients)
        grads = reduce_gradients(mesh, grads)
        loss, acc = mean_over_dp(mesh, loss), mean_over_dp(mesh, acc)
    norm = opt.norm(grads)
    opt.update(grads)
    return {"loss": loss, "grad_norm": norm, "acc": acc}


@torch.no_grad()
def eval_step(model: nn.Module, batch: Dict[str, torch.Tensor],
              inputs: Inputs = model_inputs) -> torch.Tensor:
    """Inference logits (BatchNorm on its running statistics)."""
    return _logits(model(**inputs(batch), train=False))


@dataclasses.dataclass
class EarlyStopper:
    """Best-F1 early stopping (reference: patience 10 swin / 50 fusion,
    main.py:215-235, main_bigvul.py:264-268)."""

    patience: int
    best: float = float("-inf")
    best_epoch: int = -1
    counter: int = 0

    def update(self, value: float, epoch: int) -> bool:
        """Returns True if this is a new best."""
        if value > self.best:
            self.best = value
            self.best_epoch = epoch
            self.counter = 0
            return True
        self.counter += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.counter >= self.patience
