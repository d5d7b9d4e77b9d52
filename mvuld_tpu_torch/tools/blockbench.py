"""Microbenchmark the SwinV2 block's MLP half on the card.

Counterpart of ``mvuld_tpu/tools/blockbench.py``: times the stage-3 post-
norm MLP residual sub-block  x + LN(GELU(x@W1 + b1)@W2 + b2)  (M = B·784
rows, C = 512, Hd = 2048 at 448²) in isolation, so the kernels and the
library composition can be compared without a whole-model run. Variants:

  v0  the plain composition: bf16 ``F.linear`` (bias in the product's
      epilogue), tanh GELU, fp32 LayerNorm — the JAX benchmark's XLA default
  v1  separate products and epilogues: bf16 products, then bias adds
  v2  fp32-summed products with fp32 outputs (``preferred_element_type``)
  v3  the K6 kernels: ``dense_act`` (gelu) → ``dense_ln`` (K6b backward)
  v4  the K3 kernel: ``mlp_ln`` (K3b backward)

v0-v2 take jax.nn.gelu's default tanh form, as the JAX benchmark does; v3
and v4 the exact erf of the model. ``fwd_bwd`` takes the gradients with
respect to the parameters and x, and folds every one of them into the next
iteration's x, so nothing is dead and iterations chain through a data
dependency; ``--remat`` wraps the block in ``torch.utils.checkpoint``.

Timing: CUDA events around ``--iters`` chained iterations, the best of 3
repeats after a warm-up, on the card. ``share_of_bf16_peak`` divides the
achieved rate by ``BF16_PEAK_FLOP_S``, the dense bf16 tensor-core peak of
an H100 SXM (989 TFLOP/s, NVIDIA's data sheet); the card's name is printed
beside it. ``--device cpu`` runs the same code on the host clock for the
tests and reports no share.

Run:  python -m mvuld_tpu_torch.tools.blockbench --variant v0,v1,v2,v3,v4 \\
          --batch 64 --iters 24 --mode fwd_bwd
Prints one JSON line per variant and mode.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

BF16_PEAK_FLOP_S = 989e12   # H100 SXM, dense bf16 tensor cores
VARIANTS = ("v0", "v1", "v2", "v3", "v4")


def _ln(z, gamma, beta):
    zf = z.float()
    mu = zf.mean(-1, keepdim=True)
    var = ((zf - mu) ** 2).mean(-1, keepdim=True)
    return (zf - mu) * torch.rsqrt(var + 1e-6) * gamma + beta


def build_mlp_ln(variant: str, M: int, C: int = 512, Hd: int = 2048,
                 remat: bool = False, device="cuda"):
    """Return (mlp, fwd_iter, fwd_bwd_iter, params, x0, flops_fwd) for the
    sub-block  x + LN(GELU(x@W1+b1)@W2+b2)  — the math of SwinBlockV2's
    second half. ``params`` are fp32 leaves that require grad; x0 is bf16.
    Weights come from numpy's seed 0, as in the JAX benchmark."""
    import numpy as np

    from mvuld_tpu_torch.ops.fused_dense import (dense_act, dense_ln,
                                                 matmul_f32, mlp_ln)

    if variant not in VARIANTS:
        raise ValueError(variant)
    rng = np.random.RandomState(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    params = {"w1": t(rng.randn(C, Hd) * 0.02), "b1": t(np.zeros(Hd)),
              "w2": t(rng.randn(Hd, C) * 0.02), "b2": t(np.zeros(C)),
              "gamma": t(np.ones(C)), "beta": t(np.zeros(C))}
    for p in params.values():
        p.requires_grad_()
    x0 = t(rng.randn(M, C)).to(torch.bfloat16)
    bf = torch.bfloat16

    def mlp(p, x):
        w1, w2 = p["w1"].to(bf), p["w2"].to(bf)
        if variant == "v0":
            h = F.gelu(F.linear(x, w1.t(), p["b1"].to(bf)), approximate="tanh")
            z = F.linear(h, w2.t(), p["b2"].to(bf))
            y = _ln(z, p["gamma"], p["beta"]).to(bf)
        elif variant == "v1":
            h = F.gelu(x @ w1 + p["b1"].to(bf), approximate="tanh")
            z = h @ w2
            y = _ln(z + p["b2"].to(bf), p["gamma"], p["beta"]).to(bf)
        elif variant == "v2":
            h = F.gelu(matmul_f32(x, w1) + p["b1"], approximate="tanh").to(bf)
            z = matmul_f32(h, w2)
            y = _ln(z + p["b2"], p["gamma"], p["beta"]).to(bf)
        elif variant == "v3":
            h = dense_act(x, p["w1"], p["b1"], act="gelu")
            y = dense_ln(h, p["w2"], p["b2"], p["gamma"], p["beta"])
        else:
            y = mlp_ln(x, p["w1"], p["b1"], p["w2"], p["b2"], p["gamma"],
                       p["beta"])
        return x + y.to(bf)

    def block(p, x):
        if not remat:
            return mlp(p, x)
        return torch.utils.checkpoint.checkpoint(mlp, p, x,
                                                 use_reentrant=False)

    names = list(params)

    def fwd_bwd_iter(p, x):
        x = x.detach().requires_grad_()
        loss = block(p, x).float().sum() * 1e-6
        grads = torch.autograd.grad(loss, [p[n] for n in names] + [x])
        gp, gx = dict(zip(names, grads[:-1])), grads[-1]
        # every gradient feeds the next x, as in the JAX benchmark
        gsum = sum(g.float().sum() for g in gp.values())
        return (x.detach() + gx.to(bf) * 1e-9
                + (loss.detach() + gsum).to(bf) * 1e-9
                + gp["b2"].to(bf)[None, :] * 1e-9)

    @torch.no_grad()
    def fwd_iter(p, x):
        return mlp(p, x)

    flops_fwd = 2 * 2 * M * C * Hd            # two products
    return mlp, fwd_iter, fwd_bwd_iter, params, x0, flops_fwd


def run_variant(variant: str, M: int, iters: int, mode: str,
                repeats: int = 3, C: int = 512, Hd: int = 2048,
                remat: bool = False, device="cuda") -> dict:
    device = torch.device(device)
    _, fwd_iter, fwd_bwd_iter, params, x0, flops_fwd = build_mlp_ln(
        variant, M, C, Hd, remat=remat, device=device)
    body = fwd_iter if mode == "fwd" else fwd_bwd_iter
    # products per value-and-grad w.r.t. (params, x): forward 2 + backward
    # (dh, dx, dW1, dW2) 4 = 3x; a recomputed forward adds 2 more = 4x
    # (v3's and v4's backward kernels recompute inside either way)
    mult = 1.0 if mode == "fwd" else (4.0 if remat else 3.0)
    flops_iter = flops_fwd * mult
    cuda = device.type == "cuda"

    def chain():
        x = x0
        for _ in range(iters):
            x = body(params, x)
        return x

    t0 = time.perf_counter()
    chain()                                   # warm-up (and kernel builds)
    if cuda:
        torch.cuda.synchronize(device)
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            chain()
            times.append(time.perf_counter() - t0)
    dt = min(times) / iters
    return {
        "variant": variant, "mode": mode, "M": M, "iters": iters,
        "remat": remat, "ms_per_iter": round(dt * 1e3, 4),
        "tf_per_s": round(flops_iter / dt / 1e12, 2),
        "share_of_bf16_peak": (round(flops_iter / dt / BF16_PEAK_FLOP_S, 4)
                               if cuda else None),
        "device": (torch.cuda.get_device_name(device) if cuda else "cpu"),
        "warmup_s": round(warm_s, 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="v0",
                    help="comma-separated: v0 plain, v1 separate epilogues, "
                         "v2 fp32 sums, v3 K6 dense kernels, v4 K3 mlp_ln")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--mode", default="fwd_bwd", help="fwd | fwd_bwd | both")
    ap.add_argument("--dim", type=int, default=512, help="block channels C")
    ap.add_argument("--tokens", type=int, default=784,
                    help="tokens per image at this stage (M = batch·tokens)")
    ap.add_argument("--remat", action="store_true",
                    help="wrap the block in torch.utils.checkpoint")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mvuld_tpu_torch.train.predict import resolve_device
    device = resolve_device(args.device)
    M = args.batch * args.tokens
    modes = ["fwd", "fwd_bwd"] if args.mode == "both" else [args.mode]
    rows = []
    for variant in args.variant.split(","):
        for mode in modes:
            rows.append(run_variant(variant, M, args.iters, mode,
                                    C=args.dim, Hd=4 * args.dim,
                                    remat=args.remat, device=device))
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
