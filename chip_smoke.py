#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mvuld_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. print the card's name and power limit; build the CUDA kernels of
     ``mvuld_tpu_torch/csrc`` with nvcc (all sources at once) and print the
     build seconds and ptxas's resource lines;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes one serving forward (bucket 16, bf16) gives it, and time the
     kernel, the plain version and (attention only) one
     ``scaled_dot_product_attention`` call as the library yardstick, beside
     the bound computed from the shapes;
  3. serve 37 seeded requests at full width (SwinV2-Base-448 window 28,
     UniXcoder-base, the multi_defect_new_gcn head) through the kernels,
     counting each kernel's launches, then again through the plain layers,
     and compare P(vul); profile one forward of each path (device time by
     kernel, idle share);
  4. print the kernels JSON line, the card line, and the result line last.

Needs no network and no package beyond torch and numpy: no JAX, PIL,
yaml, pandas or tokenizers (``serve`` takes the featurised arrays).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
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


def check_attention(dev, gen, rows):
    import torch
    import torch.nn.functional as F

    from mvuld_tpu_torch.ops.window_attention import (
        shift_and_scale, window_attention_flat, window_attention_flat_plain,
        window_region_mask)

    for stage, Bn, N, C, H, shift, nW1, per_fwd in K1_SHAPES:
        hd = C // H
        qkv = torch.randn(Bn, N, 3 * C, device=dev, generator=gen
                          ).to(torch.bfloat16)
        bias = 16 * torch.sigmoid(torch.randn(H, N, N, device=dev,
                                              generator=gen))
        ls = math.log(10.0) + 0.1 * torch.randn(H, device=dev, generator=gen)
        args = (qkv, bias, ls, shift, nW1, nW1)
        got = window_attention_flat(*args)
        want = window_attention_flat_plain(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = bf16_tol(want.float())

        # library yardstick: SDPA on pre-normalised q·scale, k, v with a
        # float mask of bias (+ the shift mask); timed only
        x = qkv.reshape(Bn, N, 3, H, hd).permute(2, 0, 3, 1, 4).float()
        scale, _ = shift_and_scale(ls, bias)
        q = x[0] * torch.rsqrt((x[0] ** 2).sum(-1, keepdim=True) + 1e-12)
        k = x[1] * torch.rsqrt((x[1] ** 2).sum(-1, keepdim=True) + 1e-12)
        q = (q * scale[:, None, None]).to(torch.bfloat16)
        k, v = k.to(torch.bfloat16), x[2].to(torch.bfloat16)
        nW = nW1 * nW1
        mask = bias[None, None]
        if shift:
            mask = mask + torch.as_tensor(window_region_mask(
                int(math.isqrt(N)), shift, nW1, nW1), device=dev)[None, :, None]
        mask = mask.to(torch.bfloat16)
        shp = (Bn // nW, nW, H, N, hd)
        qs, ks, vs = (t.reshape(shp) for t in (q, k, v))
        ms = time_ms(lambda: window_attention_flat(*args), 5)
        plain_ms = time_ms(lambda: window_attention_flat_plain(*args), 3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=1.0), 5)
        nbytes = Bn * N * 3 * C * 2 + H * N * N * 4 + Bn * N * C * 2
        t_bytes = nbytes / HBM_BYTES_S
        t_ops = max(4 * Bn * H * N * N * hd / FP32_FLOP_S,
                    Bn * H * N * N / SFU_EXP_S)
        rows.append(dict(kernel="window_attention_flat",
                         shape=f"stage{stage} Bn={Bn} N={N} C={C} H={H} "
                               f"shift={shift}",
                         per_fwd=per_fwd, err=err, tol=tol, ms=ms,
                         plain_ms=plain_ms, lib_ms=lib_ms,
                         t_bytes=t_bytes * 1e3, t_ops=t_ops * 1e3))

    # fp32 qkv: the same kernel without the bf16 output rounding
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


def check_mlp(dev, gen, rows, name, shapes):
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
                         per_fwd=per_fwd, err=err, tol=bf16_tol(want.float()),
                         ms=ms, plain_ms=plain_ms, lib_ms=None,
                         t_bytes=nbytes / HBM_BYTES_S * 1e3,
                         t_ops=4 * M * C * Hd / BF16_TC_FLOP_S * 1e3))


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

    # the published 448 image config
    # (configs/swinv2_base_patch4_window24to28_384to448_1ktoMYDATA_ft.yaml)
    # plus UniXcoder-base and the multi_defect_new_gcn head, as opts: the
    # card has no yaml
    opts = ["MODEL.SWINV2.EMBED_DIM", 128, "MODEL.SWINV2.DEPTHS", [2, 2, 18, 2],
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
    cfg = get_config(SimpleNamespace(cfg=None, opts=opts, output="unused"))
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

    profile_forward("kernels", fast, arrs, dev)
    profile_forward("plain", plain, arrs, dev)

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


def _category(name: str) -> str:
    if "flat_fwd" in name:
        return "K1 window_attention_flat"
    if "mlp_ln_kernel" in name:
        return "K3/K4 mlp_ln"
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "xmma", "cutlass", "cublas",
                              "nvjet", "sm90")):
        return "library GEMM"
    if any(t in low for t in ("softmax", "reduce", "norm")):
        return "softmax/norm/reduce"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def profile_forward(label: str, model, arrs, dev) -> None:
    """Device time by kernel for one bucket-16 forward under torch.profiler,
    and the device's idle share of that forward's wall time (kernels on one
    stream do not overlap, so busy time is their sum)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mvuld_tpu_torch.train.predict import serve

    one = {k: v[:BATCH] for k, v in arrs.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(model, one, BATCH, dev)
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
    print(f"profile {label}: one forward (bucket {BATCH}) wall {wall_ms:.1f} "
          f"ms, device busy {busy:.1f} ms, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}", flush=True)
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}:   {cat}: {ms:.2f} ms ({ms / busy:.1%})",
              flush=True)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile {label}:     {ms:8.2f} ms  {name[:90]}", flush=True)


KERNELS = {
    "window_attention_flat": ("mvuld_tpu_torch/csrc/window_attention_flat.cu",
                              "mvuld_tpu/ops/window_attention.py:883"),
    "mlp_ln": ("mvuld_tpu_torch/csrc/mlp_ln.cu",
               "mvuld_tpu/ops/fused_dense.py:407"),
    "mlp_ln_res": ("mvuld_tpu_torch/csrc/mlp_ln.cu",
                   "mvuld_tpu/ops/fused_dense.py:613"),
}


def summarise(rows, launches):
    """One entry per kernel; times are per serving forward at bucket 16:
    Σ over its shapes of (launches per forward × ms per launch)."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        tot = lambda key: sum(r["per_fwd"] * r[key] for r in mine)  # noqa: E731
        t_bytes, t_ops = tot("t_bytes"), tot("t_ops")
        lib = (None if any(r["lib_ms"] is None for r in mine)
               else tot("lib_ms"))
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": max(r["err"] for r in mine),
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
    _build.build_all(["window_attention_flat", "mlp_ln"])
    print(f"build: {time.time() - t0:.1f}s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    check_attention(dev, gen, rows)
    check_mlp(dev, gen, rows, "mlp_ln", K3_SHAPES)
    check_mlp(dev, gen, rows, "mlp_ln_res", K4_SHAPES)
    bad = []
    for r in rows:
        lib = "n/a" if r["lib_ms"] is None else f"{r['lib_ms']:.3f}"
        print(f"{r['kernel']} {r['shape']}: max_abs_err={r['err']:.3e} "
              f"(tol {r['tol']:.3e}) ms={r['ms']:.3f} "
              f"plain_ms={r['plain_ms']:.3f} library_ms={lib} "
              f"bound_ms={max(r['t_bytes'], r['t_ops']):.4f} "
              f"(bytes {r['t_bytes']:.4f}, operations {r['t_ops']:.4f}) "
              f"×{r['per_fwd']}/forward", flush=True)
        if not r["err"] <= r["tol"]:
            bad.append(f"{r['kernel']} {r['shape']}")
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")

    launches = serve_phase(dev)
    print(json.dumps({"kernels": summarise(rows, launches)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
