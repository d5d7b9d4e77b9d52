#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mvuld_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. print the card's name and power limit; build the CUDA kernels of
     ``mvuld_tpu_torch/csrc`` with nvcc (all sources at once) and print the
     build seconds and ptxas's resource lines;
  2. hold each kernel against its plain PyTorch version on the card and
     time the kernel, the plain version and, where one exists, the one
     PyTorch call that computes the same function (the library yardstick),
     beside the bound computed from the shapes: the forward kernels K1,
     K3, K4 (K1 with its row sums, K4 with and without its keep-mask) at
     the shapes one bucket-16 forward gives them, the backward kernels K2,
     K3b, K4b at the shapes one batch-16 training step gives them; K1, K2,
     K5 (also against K2), K3 and K3b at the shapes one batch-64 SwinV2
     fine-tune step gives them (the plain attention versions over chunks
     of windows there); and K6/K6b at blockbench's stage-3 shapes;
  3. serve 37 seeded requests at full width (SwinV2-Base-448 window 28,
     UniXcoder-base, the multi_defect_new_gcn head) through the kernels,
     counting each kernel's launches, then again through the plain layers,
     and compare P(vul); profile one forward of each path;
  4. train: one epoch of three batch-16 AdamW steps through the trainer
     CLI (``train_e2e.main``, kernels on, Swin stage 2 checkpointed) from a
     seeded synthetic cache, counting every kernel's launches; then, with
     one seeded generator per path, the first step's loss and gradients
     through the kernels against the plain layers, both held against the
     plain layers in fp32 (the bf16 plain path's own error sets the bound
     of the tensors whose exact gradient cancels), timed steps of both
     paths (ms/step, functions/s, peak memory) and a profile of one
     kernel-path step;
  5. the SwinV2 fine-tune (``train_swin``) alone at the published 448
     config, batch 64 (an out-of-memory error fails the run):
     ``--throughput`` through the kernels; a warm-up and
     three AdamW steps with mixup soft targets through the kernels under
     the v2 backward (K2) and then the v1 backward (K5), counting every
     kernel's launches (K1 once per block: never rerun in the checkpointed
     stage); the first step's gradients of both generations and of the
     plain layers against the plain layers in fp32 at batch 16, and v1
     against v2;
     a profile of one step of each generation;
  6. the block microbenchmark (``tools/blockbench.py``): its five variants
     of the stage-3 MLP half, fwd_bwd at batch 64, one JSON line each, the
     K6/K6b launches counted in v3's run;
  7. print the kernels JSON line, the card line, and the result line last.

Needs no network and no package beyond torch and numpy: no JAX, PIL,
yaml, pandas or tokenizers (``serve`` takes the featurised arrays; the
trainer starts from a prebuilt cache and tokenizer.json).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

# Published H100 SXM peaks (dense): device memory 3.35 TB/s, bf16 tensor
# cores 989 TFLOP/s, fp32 outside the tensor cores 67 TFLOP/s, and the
# special-function units' exp rate: 16 per SM per clock × 132 SMs ×
# 1.98 GHz boost.
HBM_BYTES_S = 3.35e12
BF16_TC_FLOP_S = 989e12
FP32_FLOP_S = 67e12
SFU_EXP_S = 16 * 132 * 1.98e9

BATCH = 16          # serving bucket
N_REQUESTS = 37     # → buckets 16, 16 and 8
NODE_CAPACITY = 512
VOCAB = 4096        # train_e2e's tokenizer size
P_TOL = 1e-2        # |Δp| between the kernel and the plain serving paths
REPEATS = 3         # timed serves of the 37 requests, per path

# (stage, Bn, N, C, H, shift, nWh, launches per forward) at bucket 16
K1_SHAPES = [(1, 256, 784, 128, 4, 0, 4, 1), (1, 256, 784, 128, 4, 14, 4, 1),
             (2, 64, 784, 256, 8, 0, 2, 1), (2, 64, 784, 256, 8, 14, 2, 1),
             (3, 16, 784, 512, 16, 0, 1, 18), (4, 16, 196, 1024, 32, 0, 1, 2)]
# (label, M, C, launches per forward)
K3_SHAPES = [("stage1", 200704, 128, 2), ("stage2", 50176, 256, 2),
             ("stage3", 12544, 512, 18)]
K4_SHAPES = [("function", BATCH * 512, 768, 12),
             ("lines", NODE_CAPACITY * 64, 768, 12)]
# A batch-16 training step runs the same shapes, and each backward kernel
# once per forward launch: K2 as K1, K3b as K3, K4b as K4.
SWIN_BATCH = 64     # the SwinV2 fine-tune's batch
# its step runs K1, K2 or K5 and K3 (K3b) at 4× the bucket-16 windows or
# rows, the same number of times per step
SWIN_K1_SHAPES = [(s, Bn * SWIN_BATCH // BATCH, *rest)
                  for s, Bn, *rest in K1_SHAPES]
SWIN_K3_SHAPES = [(label, M * SWIN_BATCH // BATCH, C, n)
                  for label, M, C, n in K3_SHAPES]
SCORE_BYTES = 2 ** 32    # a plain attention version's fp32 scores per chunk
KEEP = 0.9              # RoBERTa dropout 0.1: K4/K4b's keep probability
TRAIN_STEPS = 3          # timed steps per path, after one warm-up step
LOSS_TOL = 2e-2          # |Δ loss| of the first step, kernels vs plain
GRAD_TOL = 0.1           # per-tensor relative L2 of the first step's grads
GRAD_NOISE = 3.0         # … against fp32, or this × the plain bf16 path's

# K6 / K6b at blockbench's default shape (batch 64 at stage 3: M = 64·784,
# C = 512, Hd = 2048): (label, M, K, N, act, ln)
DENSE_SHAPES = [("fc1_gelu", 64 * 784, 512, 2048, "gelu", False),
                ("fc2_ln", 64 * 784, 2048, 512, "none", True)]
VEC_TOL = 1e-3           # K6b's fp32 column sums, relative L2

# the published 448 image config
# (configs/swinv2_base_patch4_window24to28_384to448_1ktoMYDATA_ft.yaml)
# plus UniXcoder-base and the multi_defect_new_gcn head, as opts: the card
# has no yaml
MODEL_OPTS = ["MODEL.SWINV2.EMBED_DIM", 128, "MODEL.SWINV2.DEPTHS", [2, 2, 18, 2],
              "MODEL.SWINV2.NUM_HEADS", [4, 8, 16, 32],
              "MODEL.SWINV2.WINDOW_SIZE", 28,
              "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", [12, 12, 12, 6],
              "MODEL.DROP_PATH_RATE", 0.2, "MODEL.NUM_CLASSES", 2,
              "DATA.IMG_SIZE", 448,
              "MODEL.UNIXCODER.HIDDEN", 768, "MODEL.UNIXCODER.LAYERS", 12,
              "MODEL.UNIXCODER.HEADS", 12, "MODEL.UNIXCODER.INTERMEDIATE", 3072,
              "DATA.FUNC_TOKENS", 512, "DATA.NODE_TOKENS", 64,
              "DATA.MAX_NODES", 100, "MODEL.MULTI.HIDDEN", 512,
              "MODEL.MULTI.NUM_RS_GCN", 8, "PARALLEL.DTYPE", "bfloat16",
              "TRAIN.FUSED_MLP", True]
# the JAX e2e training defaults (bench.py): batch 16, remat on Swin stage 2
# only, no text remat; one epoch of three steps, best snapshot params-only
# the SwinV2 fine-tune alone (train_swin): the same published config with
# its training settings, batch 64 as bench.py trains SwinV2 alone, bf16,
# the fused MLP on and the 18-block stage checkpointed; mixup/cutmix on
SWIN_OPTS = MODEL_OPTS[:16] + [
    "MODEL.LABEL_SMOOTHING", 0.1, "PARALLEL.DTYPE", "bfloat16",
    "TRAIN.FUSED_MLP", True, "TRAIN.USE_CHECKPOINT", True,
    "TRAIN.REMAT_STAGES", [2], "TRAIN.WARMUP_EPOCHS", 5,
    "TRAIN.WEIGHT_DECAY", 1e-8, "TRAIN.BASE_LR", 2e-5,
    "TRAIN.WARMUP_LR", 2e-8, "TRAIN.MIN_LR", 2e-7, "SEED", 0]
SWIN_BLOCKS = 24                # K1 launches per forward
TRAIN_OPTS = ["DATA.BATCH_SIZE", BATCH, "TRAIN.USE_CHECKPOINT", True,
              "TRAIN.REMAT_STAGES", [2], "TRAIN.TEXT_REMAT", "off",
              "TRAIN.EPOCHS", 1, "TRAIN.BEST_SAVE", "params", "SAVE_FREQ", 0,
              "PRINT_FREQ", 1, "SEED", 0]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after two warm-up calls, on
    CUDA events."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_tol(ref) -> float:
    """Two bf16 ulps at the largest output: kernel and plain version both
    compute in fp32 and round once to bf16, so they may differ by a
    rounding step."""
    return 2.0 ** -6 * float(ref.abs().max())


def rel_err(got, want) -> float:
    """max |got − want| / max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def by_windows(fn, Bn, nW, H, N, n_summed=0):
    """``fn(w)`` over slices ``w`` of whole images' windows (the shift mask
    repeats per image), each slice's fp32 [windows, H, N, N] scores within
    SCORE_BYTES: the plain attention versions hold several such tensors at
    once, more than the card holds at the fine-tune's stage 1. The outputs
    are joined along windows; the last ``n_summed`` (dbias and dscale, sums
    over windows) are added."""
    import torch

    step = max(nW, SCORE_BYTES // (H * N * N * 4) // nW * nW)
    parts = [fn(slice(i, i + step)) for i in range(0, Bn, step)]
    k = len(parts[0]) - n_summed
    return (tuple(torch.cat([p[j] for p in parts]) for j in range(k))
            + tuple(sum(p[j] for p in parts) for j in range(k, len(parts[0]))))


def check_attention(dev, gen, rows, shapes, path):
    """K1 (output and row sums) and K2 at every stage's ``shapes``; on the
    fine-tune's path (``path`` "swin") also K5, against its plain version
    and against K2 on the same inputs. The plain versions run over chunks
    of windows (``by_windows``); the kernels over all of them at once."""
    import torch
    import torch.nn.functional as F

    from mvuld_tpu_torch.ops.window_attention import (
        shift_and_scale, window_attention_flat, window_attention_flat_bwd,
        window_attention_flat_bwd_plain, window_attention_flat_bwd_v1,
        window_attention_flat_bwd_v1_plain, window_attention_flat_plain,
        window_region_mask)

    for stage, Bn, N, C, H, shift, nW1, per_fwd in shapes:
        hd, nW = C // H, nW1 * nW1
        qkv = torch.randn(Bn, N, 3 * C, device=dev, generator=gen
                          ).to(torch.bfloat16)
        bias = 16 * torch.sigmoid(torch.randn(H, N, N, device=dev,
                                              generator=gen))
        ls = math.log(10.0) + 0.1 * torch.randn(H, device=dev, generator=gen)
        args = (qkv, bias, ls, shift, nW1, nW1)
        chunks = lambda fn, n_summed=0: by_windows(  # noqa: E731
            fn, Bn, nW, H, N, n_summed)
        got = window_attention_flat(*args)
        out, r = chunks(lambda w: window_attention_flat_plain(
            qkv[w], *args[1:], return_rowsum=True))
        torch.cuda.synchronize()
        err = float((got.float() - out.float()).abs().max())
        tol = bf16_tol(out.float())

        # library yardstick: SDPA on pre-normalised q·scale, k, v with a
        # float mask of bias (+ the shift mask); timed only
        x = qkv.reshape(Bn, N, 3, H, hd).permute(2, 0, 3, 1, 4).float()
        scale, _ = shift_and_scale(ls, bias)
        q = x[0] * torch.rsqrt((x[0] ** 2).sum(-1, keepdim=True) + 1e-12)
        k = x[1] * torch.rsqrt((x[1] ** 2).sum(-1, keepdim=True) + 1e-12)
        q = (q * scale[:, None, None]).to(torch.bfloat16)
        k, v = k.to(torch.bfloat16), x[2].to(torch.bfloat16)
        del x
        mask = bias[None, None]
        if shift:
            mask = mask + torch.as_tensor(window_region_mask(
                int(math.isqrt(N)), shift, nW1, nW1), device=dev)[None, :, None]
        mask = mask.to(torch.bfloat16)
        shp = (Bn // nW, nW, H, N, hd)
        qs, ks, vs = (t.reshape(shp) for t in (q, k, v))
        ms = time_ms(lambda: window_attention_flat(*args), 5)
        plain_ms = time_ms(lambda: chunks(lambda w: (
            window_attention_flat_plain(qkv[w], *args[1:]),)), 3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=1.0), 5)
        nbytes = Bn * N * 3 * C * 2 + H * N * N * 4 + Bn * N * C * 2
        t_bytes = nbytes / HBM_BYTES_S
        t_ops = max(4 * Bn * H * N * N * hd / FP32_FLOP_S,
                    Bn * H * N * N / SFU_EXP_S)
        shape = f"stage{stage} Bn={Bn} N={N} C={C} H={H} shift={shift}"
        rows.append(dict(kernel="window_attention_flat", shape=shape,
                         path=path, per_fwd=per_fwd, err=err, tol=tol, ms=ms,
                         plain_ms=plain_ms, lib_ms=lib_ms,
                         t_bytes=t_bytes * 1e3, t_ops=t_ops * 1e3))

        # K1's row sums: fp32 sums of the same terms in another order
        r_err = rel_err(window_attention_flat(*args, return_rowsum=True)[1],
                        r)
        print(f"K1 row sums {shape}: max rel err {r_err:.3e} (tol 1e-4)",
              flush=True)
        if not r_err <= 1e-4:
            raise AssertionError(f"K1 row sums disagree: {r_err}")

        # K2 from the forward's output and row sums. Tolerances: dqkv two
        # bf16 ulps at its largest value (both round one fp32 result);
        # dbias and dscale fp32 sums over every window in another order,
        # 1e-4 and 1e-3 of their largest value
        g = torch.randn(out.shape, device=dev, generator=gen
                        ).to(torch.bfloat16)
        bargs = (qkv, bias, ls, out, r, g, shift, nW1, nW1)
        k2_plain = lambda: chunks(  # noqa: E731
            lambda w: window_attention_flat_bwd_plain(
                qkv[w], bias, ls, out[w], r[w], g[w], shift, nW1, nW1), 2)
        got = window_attention_flat_bwd(*bargs)
        want = k2_plain()
        torch.cuda.synchronize()
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        tols = [bf16_tol(want[0].float()),
                1e-4 * float(want[1].abs().max()),
                1e-3 * float(want[2].abs().max())]
        ms = time_ms(lambda: window_attention_flat_bwd(*bargs), 3)
        plain_ms = time_ms(k2_plain, 2)
        del want
        # library yardstick: SDPA's backward with the float mask as a
        # tensor that requires grad (dbias), when a backend runs it
        leaves = [t.detach().requires_grad_() for t in (qs, ks, vs)]
        mask_g = mask.detach().requires_grad_()
        gs = g.reshape(Bn, N, H, hd).permute(0, 2, 1, 3).reshape(shp)
        try:
            lo = F.scaled_dot_product_attention(*leaves, attn_mask=mask_g,
                                                scale=1.0)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                lo, leaves + [mask_g], gs, retain_graph=True), 3)
            del lo
        except RuntimeError as e:
            print(f"K2 {shape}: SDPA backward with a mask gradient does not "
                  f"run here ({str(e)[:120]})", flush=True)
            lib_ms = None
        del leaves, mask_g, gs, qs, ks, vs, q, k, v
        nbytes = (2 * Bn * N * 3 * C * 2 + 2 * Bn * N * C * 2
                  + Bn * H * N * 4 + 2 * H * N * N * 4)
        t_ops = max(10 * Bn * H * N * N * hd / FP32_FLOP_S,
                    Bn * H * N * N / SFU_EXP_S)
        rows.append(dict(kernel="window_attention_flat_bwd", shape=shape,
                         path=path, per_fwd=per_fwd, err=max(errs),
                         tol=tols[errs.index(max(errs))],
                         ok=all(e <= t for e, t in zip(errs, tols)),
                         detail=f"dqkv {errs[0]:.2e}/{tols[0]:.2e} dbias "
                                f"{errs[1]:.2e}/{tols[1]:.2e} dscale "
                                f"{errs[2]:.2e}/{tols[2]:.2e}",
                         ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                         t_bytes=nbytes / HBM_BYTES_S * 1e3,
                         t_ops=t_ops * 1e3))
        if path != "swin":
            del got, out, r
            continue

        # K5, the v1 backward, from the forward's inputs alone: against
        # its plain version with K2's tolerances, and against K2 on the
        # same inputs (the same function; K2's row term comes from the
        # bf16 output, so relative L2 within 1e-2). Its library yardstick
        # is K2's (the same SDPA backward); its bound K2's operations, and
        # bytes without o and r
        k2 = got
        vargs = (qkv, bias, ls, g, shift, nW1, nW1)
        k5_plain = lambda: chunks(  # noqa: E731
            lambda w: window_attention_flat_bwd_v1_plain(
                qkv[w], bias, ls, g[w], shift, nW1, nW1), 2)
        got = window_attention_flat_bwd_v1(*vargs)
        want = k5_plain()
        torch.cuda.synchronize()
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        tols = [bf16_tol(want[0].float()),
                1e-4 * float(want[1].abs().max()),
                1e-3 * float(want[2].abs().max())]
        vs_k2 = [rel_l2(a, b) for a, b in zip(got, k2)]
        del want, k2
        ms = time_ms(lambda: window_attention_flat_bwd_v1(*vargs), 3)
        plain_ms = time_ms(k5_plain, 2)
        nbytes = (Bn * N * 3 * C * 2 + Bn * N * C * 2 + Bn * N * 3 * C * 2
                  + 2 * H * N * N * 4)
        rows.append(dict(kernel="window_attention_flat_bwd_v1", shape=shape,
                         path=path, per_fwd=per_fwd, err=max(errs),
                         tol=tols[errs.index(max(errs))],
                         ok=(all(e <= t for e, t in zip(errs, tols))
                             and max(vs_k2) <= 1e-2),
                         detail=f"dqkv {errs[0]:.2e}/{tols[0]:.2e} dbias "
                                f"{errs[1]:.2e}/{tols[1]:.2e} dscale "
                                f"{errs[2]:.2e}/{tols[2]:.2e}; against K2 "
                                f"rel L2 {vs_k2[0]:.2e} {vs_k2[1]:.2e} "
                                f"{vs_k2[2]:.2e} (tol 1e-2)",
                         ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                         t_bytes=nbytes / HBM_BYTES_S * 1e3,
                         t_ops=t_ops * 1e3))
        del got, out, r


def check_attention_fp32(dev, gen):
    """K1 on fp32 qkv: the same kernel without the bf16 output rounding."""
    import torch

    from mvuld_tpu_torch.ops.window_attention import (
        window_attention_flat, window_attention_flat_plain)

    qkv = torch.randn(64, 784, 768, device=dev, generator=gen)
    bias = 16 * torch.sigmoid(torch.randn(8, 784, 784, device=dev,
                                          generator=gen))
    ls = torch.full((8,), math.log(10.0), device=dev)
    got = window_attention_flat(qkv, bias, ls, 14, 2, 2)
    want = window_attention_flat_plain(qkv, bias, ls, 14, 2, 2)
    err32 = float((got - want).abs().max())
    print(f"K1 fp32 check stage2 shift=14: max_abs_err={err32:.3e} "
          f"(tol 1e-4)", flush=True)
    if not err32 <= 1e-4:
        raise AssertionError(f"K1 fp32 disagrees with its plain version: "
                             f"{err32}")


def check_mlp(dev, gen, rows, name, shapes, path="e2e"):
    import torch

    from mvuld_tpu_torch.ops import fused_dense as fd

    wrapper = getattr(fd, name)
    residual = name == "mlp_ln_res"
    eps = 1e-5 if residual else 1e-6
    for label, M, C, per_fwd in shapes:
        Hd = 4 * C
        r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev,  # noqa: E731
                                                generator=gen)
        x = r(M, C).to(torch.bfloat16)
        w1, b1 = r(C, Hd, sc=C ** -0.5), r(Hd, sc=0.02)
        w2, b2 = r(Hd, C, sc=Hd ** -0.5), r(C, sc=0.02)
        gamma, beta = 1 + r(C, sc=0.1), r(C, sc=0.1)
        args = (x, w1, b1, w2, b2, gamma, beta)
        got = wrapper(*args)
        want = fd.mlp_ln_plain(*args, residual=residual, eps=eps)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ms = time_ms(lambda: wrapper(*args), 10)
        plain_ms = time_ms(lambda: fd.mlp_ln_plain(
            *args, residual=residual, eps=eps), 5)
        nbytes = 2 * M * C * 2 + 2 * C * Hd * 2 + (Hd + 3 * C) * 4
        rows.append(dict(kernel=name, shape=f"{label} M={M} C={C}",
                         path=path, per_fwd=per_fwd, err=err,
                         tol=bf16_tol(want.float()),
                         ms=ms, plain_ms=plain_ms, lib_ms=None,
                         t_bytes=nbytes / HBM_BYTES_S * 1e3,
                         t_ops=4 * M * C * Hd / BF16_TC_FLOP_S * 1e3))
        if residual:   # the training form: the dropout keep-mask
            mask = (torch.rand(M, C, device=dev, generator=gen) < KEEP
                    ).to(torch.bfloat16)
            got = wrapper(*args, mask, KEEP)
            want = fd.mlp_ln_plain(*args, residual=True, eps=eps, mask=mask,
                                   keep_prob=KEEP)
            err_m = float((got.float() - want.float()).abs().max())
            tol_m = bf16_tol(want.float())
            print(f"{name} {label} M={M} C={C} keep {KEEP}: max_abs_err="
                  f"{err_m:.3e} (tol {tol_m:.3e})", flush=True)
            if not err_m <= tol_m:
                raise AssertionError(f"{name} with its mask disagrees: "
                                     f"{err_m}")
            rows[-1]["err"] = max(err, err_m)


def check_mlp_bwd(dev, gen, rows, name, shapes, path="e2e"):
    """K3b / K4b (K4b with a keep-mask at 0.9) against the plain version:
    each of the 7 gradients within relative L2 1e-2 — both round dz and dh
    to bf16 before the products, so a value near a rounding boundary may
    round either way, and the weight gradients sum those over M rows."""
    import torch

    from mvuld_tpu_torch.ops import fused_dense as fd

    wrapper = getattr(fd, name)
    residual = name == "mlp_ln_res_bwd"
    eps = 1e-5 if residual else 1e-6
    for label, M, C, per_step in shapes:
        Hd = 4 * C
        r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev,  # noqa: E731
                                                generator=gen)
        x = r(M, C).to(torch.bfloat16)
        params = (r(C, Hd, sc=C ** -0.5), r(Hd, sc=0.02),
                  r(Hd, C, sc=Hd ** -0.5), r(C, sc=0.02), 1 + r(C, sc=0.1))
        dy = r(M, C).to(torch.bfloat16)
        extra = ()
        if residual:
            extra = ((torch.rand(M, C, device=dev, generator=gen) < KEEP
                      ).to(torch.bfloat16), KEEP)
        got = wrapper(x, dy, *params, *extra)
        want = fd.mlp_ln_bwd_plain(x, dy, *params, residual=residual,
                                   eps=eps, mask=extra[0] if extra else None,
                                   keep_prob=KEEP if extra else 1.0)
        torch.cuda.synchronize()
        l2 = [rel_l2(a, b) for a, b in zip(got, want)]
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        ms = time_ms(lambda: wrapper(x, dy, *params, *extra), 5)
        plain_ms = time_ms(lambda: fd.mlp_ln_bwd_plain(
            x, dy, *params, residual=residual, eps=eps,
            mask=extra[0] if extra else None,
            keep_prob=KEEP if extra else 1.0), 3)
        nbytes = ((3 + residual) * M * C * 2 + 2 * C * Hd * 2
                  + 2 * C * Hd * 4 + (Hd + 3 * C) * 4)
        rows.append(dict(kernel=name, shape=f"{label} M={M} C={C}",
                         path=path, per_fwd=per_step, err=err, tol=None,
                         ok=max(l2) <= 1e-2,
                         detail="rel L2 " + " ".join(
                             f"{n} {e:.1e}" for n, e in zip(
                                 ("dx", "dW1", "db1", "dW2", "db2", "dγ",
                                  "dβ"), l2)) + " (tol 1e-2)",
                         ms=ms, plain_ms=plain_ms, lib_ms=None,
                         t_bytes=nbytes / HBM_BYTES_S * 1e3,
                         t_ops=12 * M * C * Hd / BF16_TC_FLOP_S * 1e3))


def check_dense(dev, gen, rows):
    """K6 and K6b against their plain versions at blockbench's stage-3
    shapes: the bf16 outputs (y, dz) within two bf16 ulps of their largest
    value, K6b's fp32 column sums (db, dγ, dβ) within relative L2 VEC_TOL
    (sums over 50176 rows in another order). Yardstick: ``torch.addmm`` on
    the product alone (the epilogue not included)."""
    import torch

    from mvuld_tpu_torch.ops import fused_dense as fd

    for label, M, K, N, act, ln in DENSE_SHAPES:
        r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev,  # noqa: E731
                                                generator=gen)
        x, w, b = r(M, K).to(torch.bfloat16), r(K, N, sc=K ** -0.5), r(N, sc=0.02)
        gamma, beta = 1 + r(N, sc=0.1), r(N, sc=0.1)
        dy = r(M, N).to(torch.bfloat16)
        fargs = (x, w, b, gamma, beta, act, ln)
        bargs = (x, w, b, gamma, dy, act, ln)
        got, want = fd.dense_fwd(*fargs), fd.dense_fwd_plain(*fargs)
        dz, vecs = fd.dense_bwd(*bargs)
        dz_p, vecs_p = fd.dense_bwd_plain(*bargs)
        torch.cuda.synchronize()
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        lib_ms = time_ms(lambda: torch.addmm(bb, x, wb), 10)
        shape = f"{label} M={M} K={K} N={N}"
        t_ops = 2 * M * K * N / BF16_TC_FLOP_S * 1e3
        err = float((got.float() - want.float()).abs().max())
        rows.append(dict(kernel="dense_fwd", shape=shape, path="blockbench",
                         per_fwd=1, err=err,
                         tol=bf16_tol(want.float()),
                         ms=time_ms(lambda: fd.dense_fwd(*fargs), 10),
                         plain_ms=time_ms(lambda: fd.dense_fwd_plain(*fargs),
                                          5),
                         lib_ms=lib_ms,
                         t_bytes=(M * K + K * N + M * N) * 2 / HBM_BYTES_S * 1e3,
                         t_ops=t_ops))
        err = float((dz.float() - dz_p.float()).abs().max())
        tol = bf16_tol(dz_p.float())
        v_err = [rel_l2(a, b) for a, b in zip(vecs, vecs_p)]
        names = ("db", "dγ", "dβ")
        rows.append(dict(kernel="dense_bwd", shape=shape, path="blockbench",
                         per_fwd=1, err=err,
                         tol=tol, ok=err <= tol and max(v_err) <= VEC_TOL,
                         detail=f"dz {err:.2e}/{tol:.2e}; rel L2 " + " ".join(
                             f"{n} {e:.1e}" for n, e in zip(names, v_err))
                         + f" (tol {VEC_TOL})",
                         ms=time_ms(lambda: fd.dense_bwd(*bargs), 10),
                         plain_ms=time_ms(lambda: fd.dense_bwd_plain(*bargs),
                                          5),
                         lib_ms=lib_ms,
                         t_bytes=((M * K + K * N + 2 * M * N) * 2
                                  + len(vecs) * N * 4) / HBM_BYTES_S * 1e3,
                         t_ops=t_ops))
        del x, dy, got, want, dz, dz_p


def requests(cfg, n: int, seed: int = 0):
    """``n`` featurised request rows in ``build_request``'s layout, from a
    numpy seed: UniXcoder framing ([<s>, <encoder-only>, </s>] … </s>, pad
    1), 3-30 valid lines per function, edges among valid lines with
    self-loops, normalised boxes, a normal image."""
    import numpy as np

    rng = np.random.RandomState(seed)
    M, T, Tn, S = (cfg.DATA.MAX_NODES, cfg.DATA.FUNC_TOKENS,
                   cfg.DATA.NODE_TOKENS, cfg.DATA.IMG_SIZE)

    def framed(length, width):
        ids = np.full(width, 1, np.int32)
        body = rng.randint(9, VOCAB, length)
        ids[: length + 4] = np.concatenate([[0, 5, 2], body, [2]])
        return ids

    arrs = {"func_ids": np.stack([framed(rng.randint(40, T - 4), T)
                                  for _ in range(n)]),
            "node_ids": np.full((n, M, Tn), 1, np.int32),
            "image": rng.randn(n, S, S, 3).astype(np.float32),
            "pos": np.zeros((n, M, 4), np.float32),
            "adj": np.zeros((n, M, M), np.uint8),
            "node_mask": np.zeros((n, M), np.float32)}
    for i in range(n):
        nv = rng.randint(3, 31)
        arrs["node_mask"][i, :nv] = 1.0
        for j in range(nv):
            arrs["node_ids"][i, j] = framed(rng.randint(2, Tn - 4), Tn)
        x0 = rng.rand(nv, 2) * 0.5
        arrs["pos"][i, :nv] = np.concatenate([x0, x0 + 0.05], 1)
        edges = (rng.rand(nv, nv) < 0.1) * (1 << rng.randint(0, 4, (nv, nv)))
        arrs["adj"][i, :nv, :nv] = edges.astype(np.uint8)
        arrs["adj"][i, np.arange(nv), np.arange(nv)] |= np.uint8(15)
    return arrs


def serve_phase(dev):
    import numpy as np
    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.ops import fused_dense as fd
    from mvuld_tpu_torch.ops import window_attention as wa
    from mvuld_tpu_torch.train.predict import serve
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model

    cfg = get_config(SimpleNamespace(cfg=None, opts=MODEL_OPTS,
                                     output="unused"))
    arrs = requests(cfg, N_REQUESTS)

    def model(kernels: bool):
        m, _, _ = build_e2e_model(cfg, VOCAB, node_capacity=NODE_CAPACITY,
                                  use_pallas=kernels,
                                  roberta_pallas_mlp=kernels,
                                  use_pallas_mlp=kernels)
        return m

    t0 = time.time()
    fast = model(True)
    init_jax_like(fast, torch.Generator().manual_seed(0))
    fast.to(dev).eval()
    n_params = sum(p.numel() for p in fast.parameters())
    print(f"serve: model built ({n_params / 1e6:.1f}M params) in "
          f"{time.time() - t0:.1f}s", flush=True)

    def timed(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = serve(m, arrs, BATCH, dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, p

    plain = model(False)
    plain.load_state_dict(fast.state_dict())
    plain.to(dev).eval()
    serve(fast, arrs, BATCH, dev)                 # warm-ups
    serve(plain, arrs, BATCH, dev)

    counters = [wa.window_attention_flat, fd.mlp_ln, fd.mlp_ln_res]
    for c in counters:
        c.launches = 0
    t, p_fast = timed(fast)                       # the main path, counted
    launches = {c.__name__: c.launches for c in counters}
    # then in turns: plain, kernels, plain, kernels, plain
    t_fast, t_plain = [t], []
    for r in range(REPEATS):
        t, p_plain = timed(plain)
        t_plain.append(t)
        if r < REPEATS - 1:
            t_fast.append(timed(fast)[0])
    if any(c.launches != REPEATS * launches[c.__name__] for c in counters):
        raise AssertionError("the plain serving path launched a kernel")

    one = {k: v[:BATCH] for k, v in arrs.items()}
    for label, m in (("kernels", fast), ("plain", plain)):
        profile_run(f"{label} forward (bucket {BATCH})",
                    lambda: serve(m, one, BATCH, dev))

    forwards = math.ceil(N_REQUESTS / BATCH)
    per_fwd = {"window_attention_flat": 24, "mlp_ln": 22, "mlp_ln_res": 24}
    for name, n in launches.items():
        print(f"serve: {name} launched {n} times "
              f"(want {per_fwd[name]} × {forwards} forwards)", flush=True)
        if n != per_fwd[name] * forwards:
            raise AssertionError(f"{name}: {n} launches, want "
                                 f"{per_fwd[name] * forwards}")
    if p_fast.shape != (N_REQUESTS,) or not np.isfinite(p_fast).all() \
            or p_fast.min() < 0 or p_fast.max() > 1:
        raise AssertionError(f"p_vul out of range: {p_fast}")
    dp = float(np.abs(p_fast - p_plain).max())
    print(f"serve: p_vul range [{p_fast.min():.4f}, {p_fast.max():.4f}], "
          f"max |Δp| kernels vs plain {dp:.3e} (tol {P_TOL})", flush=True)
    if not dp <= P_TOL:
        raise AssertionError(f"kernel and plain serving disagree: {dp}")
    for label, ts in (("kernels", t_fast), ("plain", t_plain)):
        med = statistics.median(ts)
        print(f"serve {label}: {N_REQUESTS} functions, median of {REPEATS} "
              f"runs {med:.4f}s = {N_REQUESTS / med:.2f} functions/s "
              f"(runs {', '.join(f'{t:.4f}' for t in ts)} s) "
              f"[{card_line()}]", flush=True)
    return launches


def write_cache(out_dir: str, cfg, n_train: int, n_val: int) -> None:
    """A seeded synthetic corpus as the trainer's prebuilt inputs:
    ``cache/e2e.npz`` in ``build_e2e_cache``'s layout (``requests`` rows,
    balanced labels, train/val parts) and a ``tokenizer.json`` of the
    4096-token vocabulary."""
    import numpy as np

    n = n_train + n_val
    arrs = requests(cfg, n, seed=1)
    arrs["label"] = (np.arange(n) % 2).astype(np.int32)
    arrs["part"] = np.asarray(["train"] * n_train + ["val"] * n_val)
    arrs["node_context"] = np.asarray("none")
    os.makedirs(os.path.join(out_dir, "cache"), exist_ok=True)
    np.savez(os.path.join(out_dir, "cache", "e2e.npz"), **arrs)
    with open(os.path.join(out_dir, "tokenizer.json"), "w") as f:
        json.dump({"model": {"vocab": {f"t{i}": i for i in range(VOCAB)}},
                   "added_tokens": []}, f)


def train_phase(dev, counters):
    """(a) The main path: one epoch through ``train_e2e.main`` with the
    kernels, launches counted. (b) Kernels against plain layers: first-step
    loss and per-tensor gradients, then timed steps and peak memory."""
    import numpy as np
    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.schedule import build_schedule
    from mvuld_tpu_torch.core.train_state import (cross_entropy,
                                                  model_inputs, train_step)
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.train.harness import to_device
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model
    from mvuld_tpu_torch.train.train_e2e import main as train_main

    work = tempfile.mkdtemp(prefix="mvuld_train_")
    try:
        args = ["--output", work, "--device", dev.type, "--node-capacity",
                str(NODE_CAPACITY), "--opts",
                *_opts_args(MODEL_OPTS + TRAIN_OPTS)]
        cfg = get_config(SimpleNamespace(cfg=None, opts=MODEL_OPTS + TRAIN_OPTS,
                                         output=work))
        write_cache(cfg.OUTPUT, cfg, 3 * BATCH, BATCH)
        for c in counters:
            c.launches = 0
        t0 = time.time()
        res = train_main(args)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        with open(os.path.join(cfg.OUTPUT, "log_rank0.txt")) as f:
            losses = [float(line.split(": loss ")[1].split()[0])
                      for line in f if ": loss " in line]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"train main: 1 epoch of {len(losses)} steps + eval in "
          f"{time.time() - t0:.1f}s, losses {losses}, val "
          f"{ {k: round(v, 4) for k, v in res['history'][0].items() if k in ('acc', 'f1', 'roc_auc')} }",
          flush=True)
    for name, n in launches.items():
        print(f"train main: {name} launched {n} times", flush=True)
    if len(losses) != 3 or not np.isfinite(losses).all():
        raise AssertionError(f"train main losses: {losses}")
    idle = [n for n, k in launches.items() if k == 0]
    if idle:
        raise AssertionError(f"the training run never launched {idle}")

    # (b) kernels against plain layers, one seeded generator per path, and
    # both against the plain layers in fp32
    cfg32 = get_config(SimpleNamespace(
        cfg=None, opts=MODEL_OPTS + TRAIN_OPTS + ["PARALLEL.DTYPE", "float32"],
        output=work))

    def build(kernels, c=cfg):
        m, _, _ = build_e2e_model(c, VOCAB, node_capacity=NODE_CAPACITY,
                                  use_pallas=kernels, use_pallas_mlp=kernels,
                                  roberta_pallas_mlp=kernels)
        return m

    fast = build(True)
    init_jax_like(fast, torch.Generator().manual_seed(0))
    plain, ref = build(False), build(False, cfg32)
    for m in (plain, ref):
        m.load_state_dict(fast.state_dict())
        m.to(dev)
    fast.to(dev)
    arrs = requests(cfg, BATCH, seed=2)
    arrs["label"] = (np.arange(BATCH) % 2).astype(np.int32)

    def batch_of(n):
        return to_device({k: v[:n] for k, v in arrs.items()}, dev)

    def first_step(model, n):
        gen = torch.Generator(device=dev).manual_seed(1)
        b = batch_of(n)
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
        logits = model(**model_inputs(b), train=True, gen=gen)
        loss = cross_entropy(logits, b["label"], cfg.MODEL.LABEL_SMOOTHING)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        model.load_state_dict(stats, strict=False)   # undo the BN update
        return loss.item(), grads

    def largest_fit(label, model, n):
        """(batch, first_step) at the largest batch from ``n`` down that
        fits."""
        while True:
            try:
                return n, first_step(model, n)
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()
                if n == 1:
                    raise
                print(f"train {label}: batch {n} does not fit", flush=True)
                n //= 2

    B_plain, (lp, gp) = largest_fit("plain", plain, BATCH)
    B_cmp, (lr, gr) = largest_fit("plain fp32", ref, B_plain)
    if B_cmp < B_plain:
        lp, gp = first_step(plain, B_cmp)
    lk, gk = first_step(fast, B_cmp)
    del ref
    names = [n for n, _ in fast.named_parameters()]
    # each bf16 path's relative L2 error per tensor against the fp32 run.
    # A gradient that vanishes or cancels in exact arithmetic (the Swin
    # final norm and any bias ahead of a batch-statistics BatchNorm, the
    # logits' bias) is rounding noise on both bf16 paths, so each tensor's
    # bound is the larger of GRAD_TOL and GRAD_NOISE × the plain path's
    # own error on it
    rows = []
    for a, b, r, n in zip(gk, gp, gr, names):
        ek, ep, ekp = rel_l2(a, r), rel_l2(b, r), rel_l2(a, b)
        rows.append((ek / max(GRAD_TOL, GRAD_NOISE * ep), ek, ep, ekp, n))
    rows.sort(reverse=True)
    del gk, gp, gr
    torch.cuda.empty_cache()
    med = lambda i: statistics.median(r[i] for r in rows)  # noqa: E731
    print(f"train compare (batch {B_cmp}): first-step loss kernels "
          f"{lk:.5f} plain {lp:.5f} |Δ| {abs(lk - lp):.2e} (tol {LOSS_TOL}), "
          f"fp32 {lr:.5f}; gradient rel L2 over {len(rows)} tensors against "
          f"fp32: kernels median {med(1):.3e}, plain median {med(2):.3e}; "
          f"kernels vs plain median {med(3):.3e}; bound per tensor "
          f"max({GRAD_TOL}, {GRAD_NOISE} × plain's), "
          f"{sum(GRAD_NOISE * r[2] > GRAD_TOL for r in rows)} tensors above "
          f"{GRAD_TOL}; largest share of its bound {rows[0][0]:.3f} "
          f"({rows[0][4]})", flush=True)
    for share, ek, ep, ekp, n in rows[:6]:
        print(f"train compare:   {n}: kernels {ek:.3e} plain {ep:.3e} "
              f"against fp32, kernels vs plain {ekp:.3e}", flush=True)
    if not (math.isfinite(lk) and abs(lk - lp) <= LOSS_TOL):
        raise AssertionError(f"first-step losses disagree: {lk} vs {lp}")
    if not rows[0][0] <= 1.0:
        raise AssertionError(f"first-step gradients disagree: {rows[:3]}")

    def timed_steps(label, model, n):
        opt = build_optimizer(cfg, build_schedule(cfg, 3, n), model)
        gen = torch.Generator(device=dev).manual_seed(1)
        b = batch_of(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, times = [], []
        for i in range(1 + TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics.append(train_step(model, opt, b, gen,
                                      cfg.MODEL.LABEL_SMOOTHING))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
        if not np.isfinite(vals).all():
            raise AssertionError(f"{label}: non-finite loss/grad_norm {vals}")
        ms = statistics.median(times[1:]) * 1e3
        print(f"train {label}: batch {n}, {TRAIN_STEPS} steps after a "
              f"warm-up, median {ms:.1f} ms/step = {n / ms * 1e3:.2f} "
              f"functions/s (steps {', '.join(f'{t * 1e3:.1f}' for t in times[1:])} ms; "
              f"warm-up {times[0] * 1e3:.1f} ms), peak memory {peak:.2f} GiB, "
              f"loss/grad_norm {[(round(a, 4), round(g, 3)) for a, g in vals]} "
              f"[{card_line()}]", flush=True)
        return opt, b, gen

    opt, b, gen = timed_steps("kernels", fast, BATCH)
    profile_run(f"kernels train step (batch {BATCH})",
                lambda: train_step(fast, opt, b, gen,
                                   cfg.MODEL.LABEL_SMOOTHING))
    del opt, b, fast
    torch.cuda.empty_cache()
    timed_steps("plain", plain, B_plain)
    return launches


def _opts_args(opts):
    """Config opts as a shell passes them."""
    return [json.dumps(o) if isinstance(o, list) else str(o) for o in opts]


def _counts(counters):
    return {c.__name__: c.launches for c in counters}


def _reset(counters):
    for c in counters:
        c.launches = 0


def swin_phase(dev, counters):
    """The SwinV2 fine-tune alone (``train_swin``), at full width:
    (a) ``--throughput`` through the CLI; (b) per backward generation a
    warm-up and TRAIN_STEPS timed AdamW steps with mixup soft targets at
    SWIN_BATCH, launches counted; (c) the first step's gradients of v2, v1
    and the plain layers (bf16) against the plain layers in fp32 at BATCH,
    where the plain layers fit; (d) a profile of one step of each
    generation. Returns the launches of the counted runs."""
    import numpy as np
    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.train_state import cross_entropy, image_inputs
    from mvuld_tpu_torch.ops import window_attention as wa
    from mvuld_tpu_torch.train.harness import to_device
    from mvuld_tpu_torch.train.train_swin import build_swin_training
    from mvuld_tpu_torch.train.train_swin import main as swin_main

    def config(batch, extra=()):
        return get_config(SimpleNamespace(
            cfg=None, opts=SWIN_OPTS + ["DATA.BATCH_SIZE", batch, *extra],
            output=tempfile.gettempdir()))

    def host_batch(n, seed):
        rng = np.random.RandomState(seed)
        S = config(n).DATA.IMG_SIZE
        return {"image": rng.randn(n, S, S, 3).astype(np.float32),
                "label": (np.arange(n) % 2).astype(np.int32)}

    total = dict.fromkeys(_counts(counters), 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # (a) the throughput mode through the CLI
    B = SWIN_BATCH
    work = tempfile.mkdtemp(prefix="mvuld_swin_")
    try:
        _reset(counters)
        res = swin_main(["--throughput", "--output", work, "--device",
                         dev.type, "--opts",
                         *_opts_args(SWIN_OPTS + ["DATA.BATCH_SIZE", B])])
        torch.cuda.synchronize()
        counts = _counts(counters)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    add(counts)
    print(f"swin throughput: {res['throughput']:.2f} images/s (batch {B}, 50 "
          f"warm-up + 30 timed forwards; launches "
          f"{ {k: v for k, v in counts.items() if v} }) [{card_line()}]",
          flush=True)
    if counts["window_attention_flat"] != 80 * SWIN_BLOCKS:
        raise AssertionError(f"throughput launches: {counts}")
    torch.cuda.empty_cache()

    # (b) timed fine-tune steps, v2 then v1
    def steps(gen_name, n=SWIN_BATCH):
        os.environ["MVULD_ATTN_BWD"] = gen_name
        run = build_swin_training(config(n), dev, steps_per_epoch=3)
        raw = host_batch(n, 3)
        batches = [to_device(run.batch_hook(raw, 0, i), dev)
                   for i in range(1 + TRAIN_STEPS)]
        gen = torch.Generator(device=dev).manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        metrics, times = [], []
        for b in batches:
            t0 = time.perf_counter()
            metrics.append(run.step(b, gen))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = _counts(counters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
        return run, batches, gen, counts, times, peak, vals

    n = SWIN_BATCH
    for gen_name, bwd in (("v2", "window_attention_flat_bwd"),
                          ("v1", "window_attention_flat_bwd_v1")):
        run, batches, gen, counts, times, peak, vals = steps(gen_name)
        add(counts)
        ms = statistics.median(times[1:]) * 1e3
        print(f"swin train {gen_name} (MVULD_ATTN_BWD={gen_name}): batch {n}, "
              f"{TRAIN_STEPS} steps after a warm-up, median {ms:.1f} ms/step "
              f"= {n / ms * 1e3:.2f} images/s (steps "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times[1:])} ms; warm-up "
              f"{times[0] * 1e3:.1f} ms), peak memory {peak:.2f} GiB, "
              f"loss/grad_norm {[(round(a, 4), round(g, 3)) for a, g in vals]}"
              f", launches { {k: v for k, v in counts.items() if v} } "
              f"[{card_line()}]", flush=True)
        if not np.isfinite(vals).all():
            raise AssertionError(f"swin {gen_name}: non-finite {vals}")
        other = ("window_attention_flat_bwd_v1" if gen_name == "v2"
                 else "window_attention_flat_bwd")
        n_steps = 1 + TRAIN_STEPS
        if (counts["window_attention_flat"] != SWIN_BLOCKS * n_steps
                or counts[bwd] != SWIN_BLOCKS * n_steps or counts[other]
                or not counts["mlp_ln"] or not counts["mlp_ln_bwd"]):
            raise AssertionError(f"swin {gen_name} launches: {counts} (want "
                                 f"K1 and {bwd} {SWIN_BLOCKS} per step: K1 "
                                 f"never rerun in the checkpointed stage)")
        profile_run(f"swin {gen_name} train step (batch {n})",
                    lambda: run.step(batches[-1], gen))
        del run, batches
        torch.cuda.empty_cache()
    os.environ["MVULD_ATTN_BWD"] = "v2"

    # (c) first-step gradients against the plain layers in fp32
    def first_step(model, n, smoothing, hook):
        gen = torch.Generator(device=dev).manual_seed(1)
        b = to_device(hook(host_batch(n, 4), 0, 0), dev)
        logits = model(**image_inputs(b), train=True, gen=gen)
        loss = cross_entropy(logits, b["label"], smoothing, b["soft_label"])
        return loss.item(), torch.autograd.grad(loss, list(model.parameters()))

    def grads_at(kind, n):
        extra = ["PARALLEL.DTYPE", "float32"] if kind == "fp32" else []
        c = config(n, extra)
        run = build_swin_training(c, dev, kernels=kind.startswith("kernels"))
        if kind.startswith("kernels"):
            os.environ["MVULD_ATTN_BWD"] = kind[-2:]
        try:
            return first_step(run.model, n, run.label_smoothing,
                              run.batch_hook), run.model
        finally:
            os.environ["MVULD_ATTN_BWD"] = "v2"

    n = BATCH
    (lr_, gr), ref = grads_at("fp32", n)
    (lp, gp), plain = grads_at("plain", n)
    del ref, plain
    torch.cuda.empty_cache()
    (l2, g2), _ = grads_at("kernels_v2", n)
    (l1, g1), fast = grads_at("kernels_v1", n)
    names = [k for k, _ in fast.named_parameters()]
    del fast
    report = {}
    for label, gk, lk in (("v2", g2, l2), ("v1", g1, l1)):
        rows = sorted(((rel_l2(a, r) / max(GRAD_TOL, GRAD_NOISE * rel_l2(b, r)),
                        rel_l2(a, r), rel_l2(b, r), name)
                       for a, b, r, name in zip(gk, gp, gr, names)),
                      reverse=True)
        report[label] = rows
        med = lambda i: statistics.median(x[i] for x in rows)  # noqa: E731
        print(f"swin compare {label} (batch {n}): first-step loss kernels "
              f"{lk:.5f} plain {lp:.5f} fp32 {lr_:.5f}; gradient rel L2 over "
              f"{len(rows)} tensors against fp32: kernels median "
              f"{med(1):.3e}, plain median {med(2):.3e}; bound per tensor "
              f"max({GRAD_TOL}, {GRAD_NOISE} × plain's); largest share of "
              f"its bound {rows[0][0]:.3f} ({rows[0][3]})", flush=True)
        for share, ek, ep, name in rows[:4]:
            print(f"swin compare {label}:   {name}: kernels {ek:.3e} plain "
                  f"{ep:.3e} against fp32", flush=True)
        scales = [x for x in rows if x[3].endswith("logit_scale")]
        print(f"swin compare {label}: logit scales against fp32: kernels "
              f"median {statistics.median(x[1] for x in scales):.3e}, plain "
              f"median {statistics.median(x[2] for x in scales):.3e}",
              flush=True)
        if not (math.isfinite(lk) and abs(lk - lp) <= LOSS_TOL):
            raise AssertionError(f"swin {label}: first-step losses {lk} {lp}")
        if not rows[0][0] <= 1.0:
            raise AssertionError(f"swin {label}: gradients {rows[:3]}")
    v12 = sorted((rel_l2(a, b), name) for a, b, name in zip(g1, g2, names))
    print(f"swin compare v1 against v2: rel L2 median "
          f"{statistics.median(x[0] for x in v12):.3e}, max {v12[-1][0]:.3e} "
          f"({v12[-1][1]})", flush=True)
    if not all(math.isfinite(x[0]) for x in v12):
        raise AssertionError("swin v1 against v2: non-finite gradients")
    del g1, g2, gp, gr
    torch.cuda.empty_cache()
    return total


def blockbench_phase(dev, counters):
    """The five blockbench variants, fwd_bwd at the default shape (batch
    64, C 512); K6/K6b (and K3/K3b in v4) counted in their variant's run."""
    import torch

    from mvuld_tpu_torch.tools.blockbench import VARIANTS, run_variant

    total = dict.fromkeys(_counts(counters), 0)
    want = {"v3": ("dense_fwd", "dense_bwd"), "v4": ("mlp_ln", "mlp_ln_bwd")}
    for v in VARIANTS:
        _reset(counters)
        row = run_variant(v, 64 * 784, 24, "fwd_bwd", device=dev)
        torch.cuda.synchronize()
        counts = _counts(counters)
        for k, n in counts.items():
            total[k] += n
        launched = {k for k, n in counts.items() if n}
        if launched != set(want.get(v, ())):
            raise AssertionError(f"blockbench {v} launched {counts}")
        print(json.dumps({"blockbench": row, "card": card_line()}),
              flush=True)
    return total


def _category(name: str) -> str:
    if "flat_fwd" in name:
        return "K1 window_attention_flat"
    if "bwd_rowstats" in name:
        return "K5 window_attention_flat_bwd_v1 (row pass)"
    if "bwd_dq" in name or "bwd_dkv" in name or "bwd_dbias" in name:
        return "K2 window_attention_flat_bwd"
    if "dense_fwd" in name:
        return "K6 dense_fwd"
    if "dense_bwd_rows" in name:
        return "K6b dense_bwd"
    if "mlp_ln_kernel" in name:
        return "K3/K4 mlp_ln"
    if "bwd_rows" in name or "atb" in name or "sum_partials" in name:
        return "K3b/K4b mlp_ln_bwd"
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "nvjet", "sm90")):
        return "library GEMM"
    if any(t in low for t in ("softmax", "reduce", "norm")):
        return "softmax/norm/reduce"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def profile_run(label: str, fn) -> None:
    """Device time by kernel for one call of ``fn`` under torch.profiler,
    and the device's idle share of its wall time (kernels on one stream do
    not overlap, so busy time is their sum)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + ms
    busy = sum(by_kernel.values())
    cats = {}
    for name, ms in by_kernel.items():
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    print(f"profile {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}",
          flush=True)
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}:   {cat}: {ms:.2f} ms ({ms / busy:.1%})",
              flush=True)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile {label}:     {ms:8.2f} ms  {name[:90]}", flush=True)


KERNELS = {
    "window_attention_flat": ("mvuld_tpu_torch/csrc/window_attention_flat.cu",
                              "mvuld_tpu/ops/window_attention.py:883"),
    "window_attention_flat_bwd": (
        "mvuld_tpu_torch/csrc/window_attention_flat.cu",
        "mvuld_tpu/ops/window_attention.py:1317"),
    "mlp_ln": ("mvuld_tpu_torch/csrc/mlp_ln.cu",
               "mvuld_tpu/ops/fused_dense.py:407"),
    "mlp_ln_bwd": ("mvuld_tpu_torch/csrc/mlp_ln.cu",
                   "mvuld_tpu/ops/fused_dense.py:442"),
    "mlp_ln_res": ("mvuld_tpu_torch/csrc/mlp_ln.cu",
                   "mvuld_tpu/ops/fused_dense.py:613"),
    "mlp_ln_res_bwd": ("mvuld_tpu_torch/csrc/mlp_ln.cu",
                       "mvuld_tpu/ops/fused_dense.py:646"),
    "window_attention_flat_bwd_v1": (
        "mvuld_tpu_torch/csrc/window_attention_flat.cu",
        "mvuld_tpu/ops/window_attention.py:1042"),
    "dense_fwd": ("mvuld_tpu_torch/csrc/fused_dense.cu",
                  "mvuld_tpu/ops/fused_dense.py:74"),
    "dense_bwd": ("mvuld_tpu_torch/csrc/fused_dense.cu",
                  "mvuld_tpu/ops/fused_dense.py:165"),
}


# the path whose rows give a kernel's times in the kernels line: its first
# main path (K1-K4b the e2e model's, whose rows earlier slices reported)
SUMMARY_PATH = {"window_attention_flat_bwd_v1": "swin",
                "dense_fwd": "blockbench", "dense_bwd": "blockbench"}


def summarise(rows, launches):
    """One entry per kernel. Times: Σ over the shapes of its summary path
    of (launches per bucket-16 forward, per batch-16 training step for the
    attention and MLP backward kernels, per batch-64 fine-tune step for K5,
    or per blockbench iteration for K6/K6b) × ms per launch; its largest
    error over every path. ``launches``: every counted main-path run's
    launches."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        every = [r for r in rows if r["kernel"] == name]
        mine = [r for r in every
                if r["path"] == SUMMARY_PATH.get(name, "e2e")]
        tot = lambda key: sum(r["per_fwd"] * r[key] for r in mine)  # noqa: E731
        t_bytes, t_ops = tot("t_bytes"), tot("t_ops")
        lib = (None if any(r["lib_ms"] is None for r in mine)
               else tot("lib_ms"))
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": max(r["err"] for r in every),
                    "ms": tot("ms"), "plain_ms": tot("plain_ms"),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": lib})
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from mvuld_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.time()
    _build.build_all(["window_attention_flat", "mlp_ln", "fused_dense"])
    print(f"build: {time.time() - t0:.1f}s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    check_attention(dev, gen, rows, K1_SHAPES, "e2e")
    check_attention(dev, gen, rows, SWIN_K1_SHAPES, "swin")
    check_attention_fp32(dev, gen)
    check_mlp(dev, gen, rows, "mlp_ln", K3_SHAPES)
    check_mlp(dev, gen, rows, "mlp_ln", SWIN_K3_SHAPES, "swin")
    check_mlp(dev, gen, rows, "mlp_ln_res", K4_SHAPES)
    check_mlp_bwd(dev, gen, rows, "mlp_ln_bwd", K3_SHAPES)
    check_mlp_bwd(dev, gen, rows, "mlp_ln_bwd", SWIN_K3_SHAPES, "swin")
    check_mlp_bwd(dev, gen, rows, "mlp_ln_res_bwd", K4_SHAPES)
    check_dense(dev, gen, rows)
    bad = []
    per = lambda r: {"blockbench": "blockbench iteration",  # noqa: E731
                     "swin": f"batch-{SWIN_BATCH} fine-tune step"}.get(
        r["path"], "batch-16 step" if "bwd" in r["kernel"]
        else "bucket-16 forward")
    for r in rows:
        lib = "n/a" if r["lib_ms"] is None else f"{r['lib_ms']:.3f}"
        check = (r["detail"] if "detail" in r
                 else f"max_abs_err={r['err']:.3e} (tol {r['tol']:.3e})")
        print(f"{r['kernel']} {r['shape']}: {check} ms={r['ms']:.3f} "
              f"plain_ms={r['plain_ms']:.3f} library_ms={lib} "
              f"bound_ms={max(r['t_bytes'], r['t_ops']):.4f} "
              f"(bytes {r['t_bytes']:.4f}, operations {r['t_ops']:.4f}) "
              f"×{r['per_fwd']}/{per(r)}",
              flush=True)
        if not r.get("ok", r["err"] <= (r["tol"] or 0.0)):
            bad.append(f"{r['kernel']} {r['shape']}")
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")

    from mvuld_tpu_torch.ops import fused_dense as fd
    from mvuld_tpu_torch.ops import window_attention as wa
    counters = [wa.window_attention_flat, wa.window_attention_flat_bwd,
                wa.window_attention_flat_bwd_v1, fd.mlp_ln, fd.mlp_ln_bwd,
                fd.mlp_ln_res, fd.mlp_ln_res_bwd, fd.dense_fwd, fd.dense_bwd]
    launches = dict.fromkeys(KERNELS, 0)
    e2e = [c for c in counters if c not in (wa.window_attention_flat_bwd_v1,
                                            fd.dense_fwd, fd.dense_bwd)]
    for phase in (lambda: serve_phase(dev), lambda: train_phase(dev, e2e),
                  lambda: swin_phase(dev, counters),
                  lambda: blockbench_phase(dev, counters)):
        for name, n in phase().items():
            launches[name] += n
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"no main path launched {idle}")
    print(json.dumps({"kernels": summarise(rows, launches)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
