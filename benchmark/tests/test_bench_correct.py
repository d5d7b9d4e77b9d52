"""What decides ``correct``, on the CPU at tiny widths: the reference
agrees with the system's plain path in fp32; the control (the reference in
fp8 in the system's place) and each planted fault read not correct."""

import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.lib import checks, common
from benchmark.tests import tiny

CPU = torch.device("cpu")
CELLS = ["e2e_train_b16", "swin_ft_b64_k8", "e2e_serve_ci"]
SEED = 2 ** 31 + 12345


def _measure(name, seed=SEED):
    c = tiny.cell(name)
    return run.measure(c, common.manifest(), seed, 0.3, False, CPU,
                       time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_plain_path(name):
    result, numbers, _ = _measure(name)
    assert result["correct"], numbers
    assert result["attempted"] > 0
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
def test_control_in_fp8_is_not_correct(name):
    c = tiny.cell(name)
    entry, *_ = run.run_program(c, SEED, 0.3, False, CPU, time.perf_counter())
    ref = entry.reference("fp32")
    numbers = run.numbers_of(entry, ref, entry.reference("fp8"))
    assert not checks.judge(numbers, c["limits"]), numbers


def _frozen(monkeypatch):
    """A step that returns its state unchanged."""
    from mvuld_tpu_torch.core import optim
    monkeypatch.setattr(optim.Optimizer, "update", lambda self, grads: None)


def _half(monkeypatch):
    """Half of the batch left out: the loss is the mean over the rest."""
    from mvuld_tpu_torch.core import train_state
    ce = train_state.cross_entropy

    def half(logits, labels, *a, **k):
        n = logits.shape[0] // 2
        return ce(logits[:n], labels[:n], *a, **k)
    monkeypatch.setattr(train_state, "cross_entropy", half)


@pytest.mark.parametrize("name", ["e2e_train_b16", "swin_ft_b64_k8"])
@pytest.mark.parametrize("fault", [_frozen, _half], ids=["frozen", "half"])
def test_training_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result, numbers, _ = _measure(name)
    assert not result["correct"], numbers


def test_altered_answer_is_not_correct(monkeypatch):
    from mvuld_tpu_torch.train import predict
    serve = predict.serve

    def altered(*a, **k):
        p = serve(*a, **k)
        p[-1] = 1.0 - p[-1] if abs(p[-1] - 0.5) > 1e-3 else p[-1] + 0.25
        return p
    monkeypatch.setattr(predict, "serve", altered)
    result, numbers, _ = _measure("e2e_serve_ci")
    assert not result["correct"], numbers


def test_serve_sample_takes_every_size_served():
    c = tiny.cell("e2e_serve_ci")
    mod = common.load_module(f"{common.BENCH_DIR}/entries/{c['entry']}.py")
    entry = mod.Entry(c, SEED, CPU)
    sizes = [1, 2, 3, 4, 6] * 20 + [9]
    entry.done = [(0, n, 0.0, None) for n in sizes]
    pick = entry.sample()
    assert pick[0] == len(sizes) - 1                  # the longest first
    assert {sizes[i] for i in pick} == set(sizes)
    assert len(set(pick)) == len(pick)
    assert sum(sizes[i] for i in pick) >= c["traffic"]["sample_functions"]
    assert pick == entry.sample()                     # drawn from the seed


def test_worst_leaf_uses_the_median_floor():
    ref = {"a": 1.0, "b": 1.0, "c": 1e-9}
    prog = {"a": 1.0, "b": 1.0, "c": 2e-9}
    value, at = checks.worst_leaf(prog, ref)
    assert value == pytest.approx(1e-9) and at == "c"
    assert checks.moving_leaves({"a": 1.0, "b": 1.0, "c": 1e-9}) == ["a", "b"]
    assert checks.worst_leaf({"a": float("nan"), "b": 1.0},
                             {"a": 1.0, "b": 1.0})[0] == np.inf
