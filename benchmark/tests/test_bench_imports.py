"""No run imports JAX or the JAX package (top-level names compared whole),
and the reference imports nothing of the system under test."""

import json
import os
import subprocess
import sys

from benchmark.lib import common

ROOT = common.ROOT


def _modules(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax():
    tops = _modules(
        "import json, sys, time, torch\n"
        "from benchmark import run\n"
        "from benchmark.lib import common\n"
        "from benchmark.tests import tiny\n"
        "for name in ('e2e_train_b16', 'e2e_serve_ci'):\n"
        "    run.measure(tiny.cell(name), common.manifest(), 3, 0.2, False,\n"
        "                torch.device('cpu'), time.perf_counter())\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    assert "mvuld_tpu_torch" in tops
    assert not tops & set(common.FORBIDDEN), tops & set(common.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    tops = _modules(
        "import json, sys\n"
        "import benchmark.reference.follow, benchmark.reference.steps\n"
        "import benchmark.reference.models\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    assert not tops & {"mvuld_tpu_torch", "mvuld_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mvuld_tpu_torch", sys)
    monkeypatch.delitem(sys.modules, "mvuld_tpu", raising=False)
    assert "mvuld_tpu" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mvuld_tpu.models", sys)
    assert "mvuld_tpu" in common.forbidden_modules()


def test_run_without_a_card_prints_nothing():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "e2e_serve_ci", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
