#!/usr/bin/env python3
"""Readings that set a cell's limits: the system on many seeds, the control
and the planted faults on a few, in one process.

  python3 benchmark/calibrate.py --workload CELL --seeds 1 2 ... \\
      [--control 1 2 3] [--faults half] [--looks bf16] [--seconds S] \\
      [--out FILE]

For every seed the system's part of a run goes as in ``run.py`` (set-up,
a window of S seconds, the system freed) and its numbers are read against
the fp32 reference. For the seeds under ``--control`` the reference
computed in fp8 (``benchmark/reference/models.Precision``) stands in the
system's place; ``--faults half`` plants a loss over half of each batch in
the fp32 reference; ``--looks bf16`` reads the reference with bf16
operands the same way (a look at where a gap comes from, not a control).
Every reading is judged against the cell's limits (``correct``) and names
the leaves with the widest ``update`` gaps. One JSON line per reading goes
to stdout and to ``--out``. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run  # noqa: E402
from benchmark.lib import checks, common  # noqa: E402


def widest_update_gaps(side, ref, n: int = 5):
    """The ``n`` leaves with the widest ``update`` gap (the measure of
    ``checks.worst_leaf``), each with its reference first gradient over
    the median leaf's."""
    keep = checks.moving_leaves(ref["grad1"])
    med_u = statistics.median(ref["update"][k] for k in keep)
    med_g = statistics.median(ref["grad1"].values())
    gaps = sorted(((abs(side["update"][k] - ref["update"][k])
                    / max(ref["update"][k], med_u), k) for k in keep),
                  reverse=True)[:n]
    return [[g, k, ref["grad1"][k] / med_g] for g, k in gaps]


def readings(cell, seed: int, dev, others, seconds: float):
    """The program's reading of ``seed`` and those of ``others``: (side,
    precision, half) read by the reference in the program's place."""
    t0 = time.perf_counter()
    entry, setup_s, _, _ = run.run_program(cell, seed, seconds, False, dev, t0)
    t1 = time.perf_counter()
    ref = entry.reference("fp32")
    sides = [("program", None, time.perf_counter() - t1)]
    for name, precision, half in others:
        a = time.perf_counter()
        sides.append((name, entry.reference(precision, half=half),
                      time.perf_counter() - a))
    out = []
    for name, side, ref_s in sides:
        numbers = run.numbers_of(entry, ref, side)
        r = {"seed": seed, "side": name, "reference_s": ref_s,
             "correct": checks.judge(numbers, cell["limits"]),
             "numbers": numbers}
        if name == "program":
            r["setup_s"] = setup_s
        if entry.kind == "train":
            r["widest_update"] = widest_update_gaps(side or entry.readings,
                                                    ref)
        out.append(r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[], choices=["half"])
    ap.add_argument("--looks", nargs="*", default=[], choices=["bf16"])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    cell = common.cell(args.workload)
    dev = common.require_cards(cell["chips"])
    print(f"card: {common.card_line()}", file=sys.stderr, flush=True)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            others = []
            if seed in args.control:
                others.append(("control_fp8", "fp8", False))
                if cell["entry"] != "serve":
                    others += [(f"fault_{f}", "fp32", True)
                               for f in args.faults]
                others += [(f"look_{p}", p, False) for p in args.looks]
            for r in readings(cell, seed, dev, others, args.seconds):
                r["workload"] = args.workload
                line = json.dumps(r)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
