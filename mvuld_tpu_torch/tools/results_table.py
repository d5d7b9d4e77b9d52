"""Collect held-out TEST metrics from run directories into one table.

The port's copy of ``mvuld_tpu/tools/results_table.py``: it reads the
``history.json`` the port's ``train/harness.py`` writes (and the JAX
package's, the same file) and the ``train_baseline`` logs of either
package.

Walks the given run dirs (trainer outputs: history.json written by the
harness, or train_baseline log files), extracts the final/test metrics, and
prints a markdown table — the round-report artifact the NOTES tables are
built from (reference analog: the manual tables in the paper's RQ sections).

Usage:
  python -m mvuld_tpu_torch.tools.results_table LABEL=RUNDIR [LABEL=RUNDIR ...] \
      [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, Optional


def _find_history(run_dir: str) -> Optional[str]:
    for root, _dirs, files in os.walk(run_dir):
        if "history.json" in files:
            return os.path.join(root, "history.json")
    return None


def metrics_from_run(run_dir: str) -> Dict[str, float]:
    """TEST metrics from a harness run dir (history.json 'test' entry) or a
    train_baseline log (the 'test: {...}' line)."""
    hist = _find_history(run_dir)
    if hist:
        with open(hist) as f:
            h = json.load(f)
        test = h.get("test") or {}
        if test:
            return {k: float(v) for k, v in test.items()
                    if isinstance(v, (int, float))}
        # fall back to the last val epoch
        eps = h.get("history") or []
        return ({k: float(v) for k, v in eps[-1].items()
                 if isinstance(v, (int, float))} if eps else {})
    # train_baseline: parse the log's test-dict line
    for root, _dirs, files in os.walk(run_dir):
        for fn in files:
            if not fn.startswith("log_rank"):
                continue
            txt = open(os.path.join(root, fn)).read()
            m = None
            for m in re.finditer(r"test: (\{.*\})", txt):
                pass
            if m:
                try:
                    d = eval(m.group(1), {"__builtins__": {}})  # noqa: S307
                    return {k: float(v) for k, v in d.items()
                            if isinstance(v, (int, float))}
                except Exception:
                    continue
    return {}


COLUMNS = ("f1", "acc", "precision", "recall", "pr_auc", "roc_auc",
           "best_f1")


def main(argv=None) -> Dict[str, Dict[str, float]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("runs", nargs="+", help="LABEL=RUNDIR pairs")
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)

    table: Dict[str, Dict[str, float]] = {}
    for spec in args.runs:
        label, _, run_dir = spec.partition("=")
        table[label] = metrics_from_run(run_dir) if run_dir else {}

    header = "| model | " + " | ".join(COLUMNS) + " |"
    print(header)
    print("|" + "---|" * (len(COLUMNS) + 1))
    for label, m in table.items():
        cells = [f"{m[c]:.4f}" if c in m else "—" for c in COLUMNS]
        print(f"| {label} | " + " | ".join(cells) + " |")

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(table, f, indent=2)
    return table


if __name__ == "__main__":
    main()
