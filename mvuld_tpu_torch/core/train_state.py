"""Loss, the train and eval steps, and early stopping.

Counterpart of ``mvuld_tpu/core/train_state.py`` (reference
mvuld/main.py:251-426): one step is forward (``train=True``: dropout and
DropPath masks from the step's generator, BatchNorm statistics from the
batch and updated in place), cross-entropy with label smoothing or mixup's
soft targets, backward,
clip and the optimizer update. No loss scaling: bf16 activations with fp32
parameters, as in the JAX package.

``make_multi_train_step`` (TRAIN.FUSED_STEPS, the JAX ``lax.scan`` over K
steps) runs K optimizer steps per call on a [K, B, ...] superbatch. On
the card they are one CUDA graph: the first call runs its K steps eagerly
on a side stream (the warm-up of PyTorch's whole-network capture recipe,
counted as real steps), then records K steps reading static input
buffers; every later call copies its superbatch into those buffers and
replays the graph. The step generator is registered with the graph, so a
replay draws the masks the eager steps would; the optimizer's state lives
on the device (``core/optim.py``), and BatchNorm's running statistics are
module buffers updated in place (``models/graph_nets.batch_norm``), so the
graph carries them from step to step and call to call as the JAX scan
carries ``batch_stats``. A capture that fails raises: nothing
falls back to eager steps on the card. On the CPU it is K ``train_step``
calls.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mvuld_tpu_torch.core.optim import Optimizer
from mvuld_tpu_torch.core.tracing import span
from mvuld_tpu_torch.models.dropout import base_generator


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
    decides when to synchronise; grad_norm is the norm the clip read
    (computed once), or under MultiSteps or without a clip
    ``opt.grad_norm`` of this batch's gradients. ``mesh`` (``parallel/mesh.py``): the batch
    is this rank's block of the global batch; the gradients are averaged
    over dp before the clip, and loss and acc are the global batch's.
    Spans (``core/tracing.py``): ``step.forward``, ``step.backward`` (the
    dp reduction included), ``step.optimizer``."""
    with span("step.forward"):
        out = model(**inputs(batch), train=True, gen=gen)
        logits = _logits(out)
        loss = cross_entropy(logits, batch["label"], label_smoothing,
                             batch.get("soft_label"))
        if aux_loss:
            loss = loss + out[1]
    with span("step.backward"):
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
    with span("step.optimizer"):
        norm = opt.update(grads)
        if norm is None or opt.k > 1:
            # the clip read no norm, or the accumulated gradient's
            norm = opt.grad_norm(grads)
    return {"loss": loss, "grad_norm": norm, "acc": acc}


def _superbatch_steps(model, opt, superbatch: Mapping[str, torch.Tensor],
                      gen, num_steps: int, label_smoothing: float,
                      inputs: Inputs, aux_loss: bool, mesh,
                      data: Optional[Mapping[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """K ``train_step`` calls over a device superbatch (rows of ``data``
    gathered at ``superbatch["idx"][k]`` when ``data`` is given); the
    metrics stacked to [K]."""
    out = []
    for k in range(num_steps):
        if data is not None:
            idx = superbatch["idx"][k].long()
            batch = {key: v[idx] for key, v in data.items()}
        else:
            batch = {key: v[k] for key, v in superbatch.items()}
        out.append(train_step(model, opt, batch, gen, label_smoothing,
                              inputs, aux_loss, mesh))
    return {key: torch.stack([m[key] for m in out]) for key in out[0]}


class MultiTrainStep:
    """K optimizer steps per call (``make_multi_train_step``): ``step(
    superbatch, gen)`` or, built ``indexed``, ``step({"idx": [K, B]}, gen,
    data)`` with ``data`` the device-resident columns. Returns the metrics
    of ``train_step`` stacked to [K]. ``capture``: record a CUDA graph
    (the default on the card; never on the CPU). ``replays`` counts the
    graph's replays; the kernel wrappers' launch counters see only the
    capture, so a run launched each captured kernel captured × replays
    times."""

    def __init__(self, model, opt, num_steps: int, label_smoothing: float,
                 inputs: Inputs, aux_loss: bool, indexed: bool, mesh,
                 capture: Optional[bool]):
        self.model, self.opt, self.num_steps = model, opt, num_steps
        self.args = (label_smoothing, inputs, aux_loss, mesh)
        self.indexed, self.capture = indexed, capture
        self.graph = None
        self.static: Dict[str, torch.Tensor] = {}
        self.metrics: Dict[str, torch.Tensor] = {}
        self.bound = None               # (gen, data) of the captured graph
        self.replays = 0
        self.capture_s = 0.0            # host seconds of the capture

    def _device(self) -> torch.device:
        return self.opt.params[0].device

    def __call__(self, superbatch: Mapping, gen: Optional[torch.Generator],
                 data: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
        if (data is not None) != self.indexed:
            raise ValueError("an indexed multi-step takes the device columns "
                             "(data); a direct one takes none")
        dev = self._device()
        if dev.type != "cuda" or self.capture is False:
            sb = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                  for k, v in superbatch.items()}
            return _superbatch_steps(self.model, self.opt, sb, gen,
                                     self.num_steps, *self.args, data)
        if self.graph is None:
            return self.capture_graph(superbatch, gen, data)
        if self.bound[0] is not gen or self.bound[1] is not data:
            raise ValueError("the captured graph draws from the generator "
                             "and reads the columns it was captured with")
        self.load(superbatch)
        self.graph.replay()
        self.replays += 1
        return {k: v.clone() for k, v in self.metrics.items()}

    def load(self, superbatch: Mapping) -> None:
        """Copy a superbatch into the graph's static input buffers
        (asynchronously from page-locked memory, ``data/loader.pin_batch``).
        Span ``step.input`` (``core/tracing.py``)."""
        with span("step.input"):
            if set(superbatch) != set(self.static):
                raise ValueError(f"superbatch keys {sorted(superbatch)} != "
                                 f"the captured {sorted(self.static)}")
            for k, v in superbatch.items():
                v = torch.as_tensor(v)
                if v.shape != self.static[k].shape:
                    raise ValueError(
                        f"superbatch {k!r} {tuple(v.shape)} != the "
                        f"captured {tuple(self.static[k].shape)}")
                self.static[k].copy_(v, non_blocking=True)

    def capture_graph(self, superbatch: Mapping,
                      gen: Optional[torch.Generator],
                      data: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
        """The first call on the card: K eager steps on a side stream (the
        warm-up; they train), then the capture of K steps. Returns the
        eager steps' metrics."""
        _check_capturable(self.args[3])
        dev = self._device()
        self.static = {k: torch.as_tensor(v).to(dev, copy=True)
                       for k, v in superbatch.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = _superbatch_steps(self.model, self.opt, self.static, gen,
                                     self.num_steps, *self.args, data)
        torch.cuda.current_stream(dev).wait_stream(side)
        t0 = time.perf_counter()
        self.graph = self.record(gen, data)
        self.capture_s = time.perf_counter() - t0
        self.bound = (gen, data)
        return warm

    def record(self, gen: Optional[torch.Generator],
               data: Optional[Mapping[str, torch.Tensor]]
               ) -> "torch.cuda.CUDAGraph":
        """Capture K steps that read the static buffers and draw from
        ``gen`` (registered with the graph)."""
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(base_generator(gen))
        with torch.cuda.graph(graph):
            self.metrics = _superbatch_steps(
                self.model, self.opt, self.static, gen, self.num_steps,
                *self.args, data)
        return graph


def _check_capturable(mesh) -> None:
    """A mesh whose collectives run over gloo cannot be captured: gloo
    moves CUDA tensors through the host (``parallel/collectives.py``)."""
    if mesh is None:
        return
    import torch.distributed as dist
    for group in (mesh.dp_group, mesh.mp_group):
        if group is not None and dist.get_backend(group) == "gloo":
            raise ValueError(
                "TRAIN.FUSED_STEPS > 1 on the card needs NCCL process "
                "groups: gloo's collectives of CUDA tensors go through the "
                "host, which a CUDA graph cannot capture")


def make_multi_train_step(model: nn.Module, opt: Optimizer, num_steps: int,
                          label_smoothing: float = 0.1,
                          inputs: Inputs = model_inputs,
                          aux_loss: bool = False, indexed: bool = False,
                          mesh=None, capture: Optional[bool] = None
                          ) -> MultiTrainStep:
    """K = ``num_steps`` optimizer steps per call (module docstring; the
    JAX ``make_multi_train_step``). ``capture=False`` runs the K steps
    eagerly on the card too."""
    return MultiTrainStep(model, opt, num_steps, label_smoothing, inputs,
                          aux_loss, indexed, mesh, capture)


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
