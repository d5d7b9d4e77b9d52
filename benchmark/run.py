#!/usr/bin/env python3
"""One run of one benchmark cell on the card.

  python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

The cell's file ``benchmark/workloads/CELL.json`` names its configuration
(``benchmark/configs/<config>.json``), its entry (``benchmark/entries/
<entry>.py``: set-up, window, reference), its traffic and the limits of
the numbers that decide ``correct``. The run builds the system under test
from the seed, warms it up and drives its checked steps (set-up), measures
the window for S seconds (with ``--trace 1`` the first part of it under
``torch.profiler``), frees the system, runs the reference on what the
checked steps or the served requests produced, and prints one JSON line:
with ``--trace 0`` the cell's end-to-end metrics of ``BENCHMARK.json``,
with ``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<metric>.py``; the configuration's counts come from
``benchmark/counts/<config>.py``.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.lib import checks, common  # noqa: E402


def metric_names(manifest, cell: str, traced: bool):
    key = "per_layer" if traced else "end_to_end"
    return [m["name"] for m in manifest[key]
            if cell in m.get("workloads", [cell])]


def numbers_of(entry, ref, side=None):
    """The compared numbers of ``side`` against the reference ``ref``:
    by default the program's readings (training) or served answers; else
    another reading of the reference (the control, a planted fault)."""
    if entry.kind == "train":
        return checks.training_numbers(side or entry.readings, ref)
    got = ref["served"] if side is None else side["reference"]
    gap = float(max(abs(a - b) for a, b in zip(got, ref["reference"])))
    return {"p_gap": {"value": gap, "functions": ref["functions"],
                      "requests": ref["requests"]}}


def run_program(cell, seed: int, seconds: float, traced: bool, dev,
                t_start: float):
    """The system under test's part of a run: set-up, the window, the
    peak, then the system freed. Returns (entry, setup_s, raw, peak)."""
    import torch
    cuda = dev.type == "cuda"
    entry_mod = common.load_module(os.path.join(
        common.BENCH_DIR, "entries", f"{cell['entry']}.py"))
    entry = entry_mod.Entry(cell, seed, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    entry.setup()
    setup_s = time.perf_counter() - t_start
    raw = entry.window(seconds, traced)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    entry.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return entry, setup_s, raw, peak


def measure(cell, manifest, seed: int, seconds: float, traced: bool, dev,
            t_start: float):
    """Set-up, window, reference and metrics of one run on ``dev``.
    Returns (result, numbers, notes)."""
    import torch
    cuda = dev.type == "cuda"
    entry, setup_s, raw, peak = run_program(cell, seed, seconds, traced, dev,
                                            t_start)
    numbers = numbers_of(entry, entry.reference())
    correct = checks.judge(numbers, cell["limits"])
    counts = common.load_module(os.path.join(
        common.BENCH_DIR, "counts", f"{cell['config']}.py"))
    ctx = {"raw": raw, "setup_s": setup_s, "peak_bytes": peak, "notes": [],
           "work": counts.work(cell["model"], cell["traffic"], raw),
           "traced_work": (counts.work(cell["model"], cell["traffic"], raw,
                                       traced=True) if raw.get("trace")
                           else None)}
    units = {m["name"]: m["unit"]
             for m in manifest["end_to_end"] + manifest["per_layer"]}
    metrics = {}
    for name in metric_names(manifest, cell["name"], traced):
        reader = common.load_module(os.path.join(common.BENCH_DIR, "metrics",
                                                 f"{name}.py"))
        v = reader.read(ctx)
        if v is not None and math.isfinite(v):
            metrics[name] = {"value": v, "unit": units[name]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": raw["attempted"],
              "failed": raw["failed"], "metrics": metrics, "device": device}
    tr = raw.get("trace")
    if tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["check"] = {k: {"value": n["value"], "limit": n["limit"]}
                       for k, n in numbers.items()}
    notes = ctx["notes"] + [
        f"window: {raw['window_s']:.6f} s, {raw['attempted']} "
        f"{'steps' if entry.kind == 'train' else 'requests'}; set-up "
        f"{setup_s:.6f} s; peak {peak} bytes"]
    return result, numbers, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    common.set_cache_dirs()
    cell = common.cell(args.workload)
    manifest = common.manifest()
    dev = common.require_cards(cell["chips"])
    import torch
    print(f"card: {common.card_line()}; torch {torch.__version__}",
          file=sys.stderr, flush=True)
    result, numbers, notes = measure(cell, manifest, args.seed, args.seconds,
                                     bool(args.trace), dev, T_START)
    found = common.forbidden_modules()
    if found:
        print(f"error: the run holds {found} (forbidden top-level modules)",
              file=sys.stderr)
        return 3
    for note in notes:
        print(note, file=sys.stderr)
    for k, n in numbers.items():
        extra = {kk: vv for kk, vv in n.items() if kk not in ("value", "limit")}
        print(f"check {k}: {n['value']:.6e} limit {n['limit']} {extra or ''}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
