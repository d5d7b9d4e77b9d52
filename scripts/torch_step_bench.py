"""Eager e2e train steps and the AdamW update alone, timed on the card, for
comparing two trees of the port.

    PYTHONPATH=<tree> python scripts/torch_step_bench.py [--steps N]

``mvuld_tpu_torch`` comes from the tree PYTHONPATH names; the width comes
from this checkout's ``chip_smoke.py`` (its e2e training config: SwinV2-B
448 with DropPath 0.2, UniXcoder-base with dropout 0.1, bf16, the kernels,
line capacity 512, batch 16; seeded weights and requests). Cases, each N timed
calls after two warm-ups (host clock around a synchronised call; their
median and mean, which differ under accumulation, where every second call
applies the update):

  * ``step``: ``train_step`` (forward, backward, clip, AdamW) with
    TRAIN.ACCUMULATION_STEPS 1 and 2;
  * ``update``: ``Optimizer.update`` alone on seeded gradients of the
    model's parameters, ACCUMULATION_STEPS 1 and 2.

Prints one JSON line per case, then the card's name and power limit.
Compare two trees within one machine: run tree A, B, B, A.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import time
from types import SimpleNamespace


def _smoke():
    """This checkout's chip_smoke.py, loaded without putting the checkout
    on the path (the tree under test comes from PYTHONPATH)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed(fn, n: int):
    import torch
    times = []
    for i in range(2 + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import mvuld_tpu_torch
    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.schedule import build_schedule
    from mvuld_tpu_torch.core.train_state import train_step
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.ops import _build
    from mvuld_tpu_torch.train.harness import to_device
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model

    smoke = _smoke()
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_bench: no CUDA device")
    dev = torch.device("cuda")
    tree = os.path.dirname(os.path.dirname(os.path.abspath(
        mvuld_tpu_torch.__file__)))
    _build.build_all(["window_attention", "mlp_ln", "fused_dense"])
    B = smoke.BATCH

    def config(k):
        return get_config(SimpleNamespace(
            cfg=None, opts=smoke.MODEL_OPTS + smoke.TRAIN_OPTS
            + ["TRAIN.ACCUMULATION_STEPS", k], output="unused"))

    model, _, _ = build_e2e_model(config(1), smoke.VOCAB,
                                  node_capacity=smoke.NODE_CAPACITY,
                                  use_pallas=True, use_pallas_mlp=True,
                                  roberta_pallas_mlp=True)
    init_jax_like(model, torch.Generator().manual_seed(0))
    model.to(dev)
    arrs = smoke.requests(config(1), B, seed=2)
    arrs["label"] = (np.arange(B) % 2).astype(np.int32)
    batch = to_device(arrs, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    grads = [1e-3 * torch.randn(p.shape, generator=g, device=dev)
             for p in model.parameters()]
    n_params = sum(p.numel() for p in model.parameters())

    for case in ("step", "update"):
        for k in (1, 2):
            cfg = config(k)
            opt = build_optimizer(cfg, build_schedule(cfg, 3, B), model)
            gen = torch.Generator(device=dev).manual_seed(1)
            if case == "step":
                fn = lambda: train_step(model, opt, batch, gen,  # noqa: E731
                                        cfg.MODEL.LABEL_SMOOTHING)
            else:
                fn = lambda: opt.update(grads)  # noqa: E731
            times = _timed(fn, args.steps)
            print(json.dumps({"tree": tree, "case": case,
                              "accumulation_steps": k, "batch": B,
                              "params": n_params,
                              "ms": statistics.median(times),
                              "mean_ms": statistics.mean(times),
                              "times_ms": times}), flush=True)
            del opt, fn
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0],
          flush=True)


if __name__ == "__main__":
    main()
