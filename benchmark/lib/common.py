"""What every run shares: paths, seeds, the card, caches and the import
guard."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, List

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# Published NVIDIA H100 SXM peaks (data sheet, dense): bf16 tensor cores,
# HBM3 bandwidth, and the special-function units' exp rate (16 per SM per
# clock × 132 SMs × 1.98 GHz boost).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_SFU_EXPS = 16 * 132 * 1.98e9

# modules no run may hold once its window has closed, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "mvuld_tpu")


def read_json(*parts: str) -> Dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def manifest() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(path: str):
    """A module from its file (file names may hold dots)."""
    name = "bench_" + os.path.relpath(path, BENCH_DIR).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> Dict:
    """A cell's file with its configuration's file under "model"."""
    path = os.path.join(BENCH_DIR, "workloads", f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"no cell {name!r}: {path} does not exist")
    w = read_json("workloads", f"{name}.json")
    w["name"] = name
    w["model"] = read_json("configs", f"{w['config']}.json")
    return w


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` 31-bit seeds derived from any non-negative integer."""
    return [int(s) for s in
            np.random.SeedSequence(seed).generate_state(n) % (2 ** 31)]


def forbidden_modules() -> List[str]:
    """The forbidden top-level names present in ``sys.modules``."""
    tops = {k.split(".", 1)[0] for k in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed places inside the checkout (the
    port's own kernel cache is ``build/mvuld_tpu_torch`` there already);
    no library loads JAX on its own."""
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out[0] if out else "nvidia-smi printed nothing"


def require_cards(n: int):
    """The first card, or exit non-zero with a message: no CPU fallback."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card is available; this benchmark "
                         "measures the H100 and does not run on the CPU")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"error: the cell needs {n} cards and "
                         f"{torch.cuda.device_count()} are visible")
    torch.cuda.init()
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)



def logs_at(it: int, steps: int, freq: int) -> bool:
    """Whether ``train/harness.fit`` writes its log line, and so reads the
    loss on the host (its one synchronise), after the call whose first
    step is ``it`` and which runs ``steps`` steps; ``freq`` is PRINT_FREQ."""
    return it % freq < steps
