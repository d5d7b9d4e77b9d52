"""The system under test, built as its trainers and its serving CLI build
it, with the benchmark's seeded weights; and its readings.

Only this file and the entries import ``mvuld_tpu_torch``.
"""

from __future__ import annotations

import types
from typing import Dict

import torch

from benchmark.lib import checks, weights


def config(model_cfg: Dict):
    from mvuld_tpu_torch.config import get_config
    return get_config(types.SimpleNamespace(opts=list(model_cfg["opts"])))


def constant_schedule(lr: float):
    """A schedule of one rate (its table has one entry)."""
    def schedule(count: int) -> float:
        return lr
    schedule.total_steps = 0
    return schedule


def load_weights(model: torch.nn.Module, seed: int, device) -> None:
    weights.load(model, weights.make(
        weights.spec_of(model.named_parameters()), seed, device))


def e2e_model(model_cfg: Dict, device, node_capacity, kernels: bool):
    """``EndToEndMVulD`` as ``train_e2e`` / ``predict`` build it (both
    fused MLPs with TRAIN.FUSED_MLP), made on ``device``."""
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model
    cfg = config(model_cfg)
    fused = kernels and bool(cfg.TRAIN.FUSED_MLP)
    with torch.device(device):
        model, _, _ = build_e2e_model(
            cfg, model_cfg["data"]["vocab"], node_capacity=node_capacity,
            use_pallas=kernels, roberta_pallas_mlp=fused,
            use_pallas_mlp=fused)
    return cfg, model


def optimizer(cfg, model, lr: float):
    from mvuld_tpu_torch.core.optim import build_optimizer
    return build_optimizer(cfg, constant_schedule(lr), model)


def first_grad_norms(opt) -> Dict[str, float]:
    """The first (clipped) gradient as the optimizer got it, per leaf, from
    its first moment after one step: m₁ = (1 − β₁)·g."""
    return checks.norms(dict(zip(opt.names, opt.mu)), 1.0 / (1.0 - opt.b1))


def update_norms(model, seed: int, device) -> Dict[str, float]:
    """‖p − p₀‖ per leaf, p₀ made again from the weights' seed."""
    named = dict(model.named_parameters())
    start = weights.make(weights.spec_of(named.items()), seed, device)
    out = checks.change_norms(named, start)
    del start
    return out


def bn_norms(model) -> Dict[str, float]:
    """‖s − s₀‖ per BatchNorm running statistic (s₀: mean 0, variance 1)."""
    out = {}
    for k, b in model.named_buffers():
        if k.endswith("running_mean"):
            out[k] = b.detach().float()
        elif k.endswith("running_var"):
            out[k] = b.detach().float() - 1.0
    return checks.norms(out)


def grad_rms_norms(opt) -> Dict[str, float]:
    """‖√v‖ per leaf: Adam's second moment after the steps so far (the
    gradients' weighted root mean square, as the optimizer got them)."""
    return checks.norms({k: torch.sqrt(v) for k, v in zip(opt.names, opt.nu)})
