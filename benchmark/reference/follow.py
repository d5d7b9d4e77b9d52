"""The reference following a cell's checked steps, or serving its rows.

Given a configuration's file, the weights' seed, the generator's seed and
the same device batches the system under test took, the reference builds
its own model, loads the seeded weights, draws the same masks and runs the
steps in fp32 (TF32 off) or, as the control, in ``Precision`` "fp8". It
returns the readings that ``benchmark/lib/checks.py`` compares: the
losses, the first clipped gradient's norm per leaf, the parameters'
change per leaf, the BatchNorm statistics' change per buffer after the
first step, and per leaf the norm of √v, Adam's second moment after the
last step (the gradients' weighted root mean square).

This file imports torch, the reference and the weight table only.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.lib import weights
from benchmark.reference import steps
from benchmark.reference.models import EndToEnd, Precision, SwinV2


def _fp32_products() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build(model_cfg: Dict, device) -> torch.nn.Module:
    with torch.device(device):
        if model_cfg["kind"] == "e2e":
            return EndToEnd(model_cfg["text"], model_cfg["swin"],
                            model_cfg["head"])
        return SwinV2(**model_cfg["swin"],
                      num_classes=model_cfg["head"]["classes"])


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    if not names:
        return {}
    v = torch.stack([tensors[k].float().norm() for k in names]).tolist()
    return dict(zip(names, v))


def _bn_state(model) -> Dict[str, torch.Tensor]:
    return {k: b.detach().clone() for k, b in model.named_buffers()
            if k.endswith("running_mean") or k.endswith("running_var")}


def follow(model_cfg: Dict, train: Dict, w_seed: int, g_seed: int,
           batches: List[Dict[str, torch.Tensor]], device,
           precision: str = "fp32", half: bool = False) -> Dict:
    """The readings of ``len(batches)`` training steps. ``train``: the
    cell's "train" parameters (lr, label_smoothing, node_capacity, blocks);
    ``half``: the loss over half of each batch (a planted fault)."""
    _fp32_products()
    Precision.mode = precision
    try:
        model = build(model_cfg, device)
        table = weights.make(weights.spec_of(model.named_parameters()),
                             w_seed, device)
        weights.load(model, table)
        start = {k: v.clone() for k, v in table.items()}
        del table
        bn0 = _bn_state(model)
        opt_cfg = model_cfg["optimizer"]
        opt = steps.AdamW(dict(model.named_parameters()), train["lr"],
                          steps.decay_names(model), opt_cfg["clip"],
                          opt_cfg["weight_decay"], tuple(opt_cfg["betas"]),
                          opt_cfg["eps"])
        gen = torch.Generator(device=device).manual_seed(g_seed)
        losses, grad1, bn1 = [], None, None
        for i, b in enumerate(batches):
            if model_cfg["kind"] == "e2e":
                masks = steps.draw_e2e_masks(model, b, gen,
                                             train.get("node_capacity"))
                loss = steps.e2e_grads(model, b, masks,
                                          train["label_smoothing"],
                                          train["blocks"],
                                          train.get("node_capacity"), half)
                del masks
            else:
                drops = steps.draw_swin_drops(model, b["image"].shape[0],
                                              gen, device)
                loss = steps.swin_grads(model, b["image"], b["label"], drops,
                                        train["label_smoothing"],
                                        train["blocks"]["image"], half)
            losses.append(float(loss))
            clipped = opt.step()
            if i == 0:
                grad1 = _norms(clipped)
                with torch.no_grad():
                    bn = _bn_state(model)
                    bn1 = _norms({k: bn[k] - bn0[k] for k in bn})
            del clipped
        with torch.no_grad():
            now = dict(model.named_parameters())
            update = _norms({k: now[k] - start[k] for k in start})
            grad_rms = _norms({k: torch.sqrt(v) for k, v in opt.v.items()})
        return {"losses": losses, "grad1": grad1, "update": update,
                "bn1": bn1, "grad_rms": grad_rms}
    finally:
        Precision.mode = "fp32"


def probs(model_cfg: Dict, w_seed: int, rows: Dict[str, torch.Tensor],
          blocks: Dict, device, precision: str = "fp32") -> torch.Tensor:
    """P(vul) of every row of ``rows`` (device tensors) in inference."""
    _fp32_products()
    Precision.mode = precision
    try:
        model = build(model_cfg, device)
        weights.load(model, weights.make(
            weights.spec_of(model.named_parameters()), w_seed, device))
        model.eval()
        return steps.e2e_probs(model, rows, blocks)
    finally:
        Precision.mode = "fp32"
