"""The reference following a Swin-MoE cell's checked steps, and the seeded
weight table both sides of that comparison load.

``weight_table`` is ``benchmark/lib/weights.make`` with the MoE layers'
leaves put on their own scale: ``weights.make`` scales a ≥2-d tensor by
1/√prod(shape[1:]), which for the experts' [E, D, Hd] ``w1`` is 1/√(D·Hd)
and for the gate [D, E] 1/√E. Here ``gate`` and ``w1`` take N(0, 1/D),
``w2`` N(0, 1/Hd) (their true fan-in) and ``b1`` / ``b2`` N(0, 0.02²),
each from the same standard normal draw ``make`` made for it.

``follow`` runs the steps as ``benchmark/reference/follow.follow`` does:
the same device batches, the draws of every step from one generator in
the trainer's order (``swin_moe.draw_masks``), fp32 products with TF32
off (or the control's ``Precision``), ``steps.AdamW``; the loss is the
label-smoothed cross-entropy plus the MoE layers' aux losses, over the
whole batch at once (the routing needs every token), each block's
activations recomputed in the backward under ``remat``.

This file imports torch, the reference and the weight table only.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.lib import weights
from benchmark.reference import steps
from benchmark.reference.follow import _fp32_products, _norms
from benchmark.reference.models import Precision
from benchmark.reference.swin_moe import SwinMoE, draw_masks

MOE_LEAVES = ("gate", "w1", "w2", "b1", "b2")


def _moe_scale(name: str, shape) -> float:
    """gate [D, E], w1 [E, D, Hd], w2 [E, Hd, D]: fan-in shape[-2]."""
    if name.endswith(("b1", "b2")):
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def weight_table(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """``weights.make``'s table with the MoE leaves (names ending in
    ``.mlp.gate``, ``.mlp.w1``, ``.mlp.w2``, ``.mlp.b1``, ``.mlp.b2``)
    rescaled to N(0, 1/fan_in) and biases N(0, 0.02²)."""
    table = weights.make(spec, seed, device)
    for name, shape in spec:
        parts = name.rsplit(".", 2)
        if len(parts) == 3 and parts[1] == "mlp" and parts[2] in MOE_LEAVES:
            old, _ = weights._scale_shift(name, shape)
            table[name].mul_(_moe_scale(name, shape) / old)
    return table


def build(model_cfg: Dict, device) -> SwinMoE:
    with torch.device(device):
        return SwinMoE(model_cfg["swin"], model_cfg["moe"],
                       model_cfg["head"]["classes"])


def decay_names(model) -> Dict[str, bool]:
    """The port's decay mask on this model: ≥2-d parameters other than
    the position-bias tables (the experts' [E, 1, Hd] biases included)."""
    return {k: p.dim() > 1 and "relative_position_bias_table" not in k
            for k, p in model.named_parameters()}


def grads(model: SwinMoE, images, labels, draws, smoothing: float,
          remat: bool, half: bool = False) -> torch.Tensor:
    """Loss of one step (the parameters' ``.grad`` hold its gradients).
    ``half``: the cross-entropy over the first half of the batch only (a
    planted fault)."""
    logits, aux = model(images.float(), draws, remat=remat)
    B = logits.shape[0]
    ce = steps.cross_entropy(logits, labels, smoothing,
                             B // 2 if half else None)
    loss = ce + aux
    loss.backward()
    return loss.detach()


def follow(model_cfg: Dict, train: Dict, w_seed: int, g_seed: int,
           batches: List[Dict[str, torch.Tensor]], device,
           precision: str = "fp32", half: bool = False) -> Dict:
    """The readings of ``len(batches)`` training steps (``follow.follow``'s
    keys; ``bn1`` None: the model has no BatchNorm)."""
    _fp32_products()
    Precision.mode = precision
    try:
        model = build(model_cfg, device)
        table = weight_table(weights.spec_of(model.named_parameters()),
                             w_seed, device)
        weights.load(model, table)
        start = {k: v.clone() for k, v in table.items()}
        del table
        o = model_cfg["optimizer"]
        opt = steps.AdamW(dict(model.named_parameters()), train["lr"],
                          decay_names(model), o["clip"], o["weight_decay"],
                          tuple(o["betas"]), o["eps"])
        gen = torch.Generator(device=device).manual_seed(g_seed)
        losses, grad1 = [], None
        for i, b in enumerate(batches):
            draws = draw_masks(model, b["image"].shape[0], gen, device)
            loss = grads(model, b["image"], b["label"], draws,
                         train["label_smoothing"], train.get("remat", False),
                         half)
            del draws
            losses.append(float(loss))
            clipped = opt.step()
            if i == 0:
                grad1 = _norms(clipped)
            del clipped
        with torch.no_grad():
            now = dict(model.named_parameters())
            update = _norms({k: now[k] - start[k] for k in start})
            grad_rms = _norms({k: torch.sqrt(v) for k, v in opt.v.items()})
        return {"losses": losses, "grad1": grad1, "update": update,
                "bn1": None, "grad_rms": grad_rms}
    finally:
        Precision.mode = "fp32"
