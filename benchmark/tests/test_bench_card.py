"""On the card: one short run of each cell reads correct and prints its
metrics (skips without a card, deciding inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.lib import common


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"]
                                  for w in common.manifest()["workloads"]])
def test_short_run_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          name, "--seed", "987654321987", "--seconds", "3",
                          "--trace", "0"], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=1200,
                         env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
