"""The readers of the program's spans (``benchmark/metrics/spans.py`` and
the metrics that use it): None where they have nothing to read, the right
milliseconds from a hand-filled registry, and on the CPU the tiny cells'
traced runs, with a CPU profile in place of the card's, read them all."""

import os
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run
from benchmark.lib import common, trace
from benchmark.tests import tiny

M = common.manifest()
SPAN_METRICS = {m["name"]: m["workloads"] for m in M["per_layer"]
                if m["source"] == "program_span"}
SPANS = {  # metric → span it reads
    "feed_wait_ms.train": "feed.wait", "feed_make_ms.train": "feed.make",
    "step_input_ms.train": "step.input", "forward_ms.train": "step.forward",
    "backward_ms.train": "step.backward",
    "optimizer_ms.train": "step.optimizer",
    "feed_wait_ms.finetune": "feed.wait",
    "feed_make_ms.finetune": "feed.make",
    "step_input_ms.finetune": "step.input",
    "serve_input_ms.serve": "serve.input",
    "serve_forward_ms.serve": "serve.forward",
    "serve_fetch_ms.serve": "serve.fetch"}


def _reader(name):
    return common.load_module(os.path.join(common.BENCH_DIR, "metrics",
                                           f"{name}.py"))


def _train_raw(k=1):
    """A traced e2e window (k 1: 3 traced steps, 4 calls) or a fine-tune
    window (k 8: 1 traced call of 8 steps, 3 calls)."""
    calls = 4 if k == 1 else 3
    return {"kind": "train", "steps": calls * k,
            "host_step_s": [0.5, 0.6, 0.7, 0.9][:calls],
            "trace": {"steps": 3 if k == 1 else 8}}


def _serve_raw():
    return {"kind": "serve", "trace": {"steps": None},
            "traced_requests": [(0, 4)] * 10,
            "latencies_s": [0.2] * 10 + [1.0] * 5}


def _ctx(raw):
    return {"raw": raw, "notes": []}


def _snap(**spans):
    return {name.replace("_", "."): {"n": n, "s": s, "first_ns": 1,
                                     "last_ns": 2}
            for name, (n, s) in spans.items()}


@pytest.fixture
def registry(monkeypatch):
    """Hand the readers a registry: ``registry(snapshot)``."""
    from mvuld_tpu_torch.core import tracing

    def fill(snap):
        monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    return fill


def test_every_span_metric_has_its_span_here():
    assert set(SPAN_METRICS) == set(SPANS)
    for name, cells in SPAN_METRICS.items():
        assert len(cells) == 1 and cells[0] in (
            "e2e_train_b16", "swin_ft_b64_k8", "e2e_serve_ci"), name


@pytest.mark.parametrize("name", sorted(SPANS))
def test_a_reader_of_another_kind_or_an_empty_registry_reads_none(
        name, registry):
    span = SPANS[name]
    full = _snap(**{span.replace(".", "_"): (3, 1.5)})
    other = _serve_raw() if name.endswith((".train", ".finetune")) \
        else _train_raw()
    registry(full)
    assert _reader(name).read(_ctx(other)) is None
    untraced = dict(other, kind="serve" if other["kind"] == "train"
                    else "train", trace=None)
    assert _reader(name).read(_ctx(untraced)) is None
    registry({})
    own = _serve_raw() if name.endswith(".serve") else _train_raw()
    assert _reader(name).read(_ctx(own)) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "mvuld_tpu_torch.core.tracing", None)
    for name in SPANS:
        own = _serve_raw() if name.endswith(".serve") else _train_raw()
        assert _reader(name).read(_ctx(own)) is None, name


def test_train_readers_from_a_hand_filled_registry(registry):
    registry(_snap(feed_wait=(3, 0.003), feed_make=(4, 0.2),
                   step_input=(3, 0.03), step_forward=(3, 0.6),
                   step_backward=(3, 0.45), step_optimizer=(3, 0.12)))
    want = {"feed_wait_ms.train": 1.0, "feed_make_ms.train": 50.0,
            "step_input_ms.train": 10.0, "forward_ms.train": 200.0,
            "backward_ms.train": 150.0, "optimizer_ms.train": 40.0}
    ctx = _ctx(_train_raw())
    for name, v in want.items():
        assert _reader(name).read(ctx) == pytest.approx(v), name
    assert len(ctx["notes"]) == 7
    # 401 ms of phases a step against the 3 traced steps' 600 ms
    total = [n for n in ctx["notes"] if "against the traced" in n]
    assert len(total) == 1 and "= 401.000000 ms" in total[0]
    assert "600.000000 ms (66.83 %)" in total[0]


def test_finetune_readers_from_a_hand_filled_registry(registry):
    registry(_snap(feed_wait=(1, 3.2), feed_make=(2, 8.0),
                   step_input=(1, 0.08)))
    ctx = _ctx(_train_raw(k=8))
    assert _reader("feed_wait_ms.finetune").read(ctx) == pytest.approx(400)
    # 4 s a superbatch of 8 steps
    assert _reader("feed_make_ms.finetune").read(ctx) == pytest.approx(500)
    assert _reader("step_input_ms.finetune").read(ctx) == pytest.approx(10)
    total = [n for n in ctx["notes"] if "against the traced" in n]
    assert len(total) == 1 and "= 410.000000 ms" in total[0]
    assert "500.000000 ms" in total[0]         # the first call's 0.5 s


def test_serve_readers_from_a_hand_filled_registry(registry):
    registry(_snap(serve_input=(20, 0.5), serve_forward=(20, 1.0),
                   serve_fetch=(20, 0.4)))
    ctx = _ctx(_serve_raw())
    assert _reader("serve_input_ms.serve").read(ctx) == pytest.approx(50)
    assert _reader("serve_forward_ms.serve").read(ctx) == pytest.approx(100)
    assert _reader("serve_fetch_ms.serve").read(ctx) == pytest.approx(40)
    total = [n for n in ctx["notes"] if "against the traced" in n]
    assert len(total) == 1 and "= 190.000000 ms" in total[0]
    assert "200.000000 ms (95.00 %)" in total[0]   # the 10 traced ones


class CpuTraced(trace.Traced):
    """``trace.Traced`` with a CPU profile (no card here)."""

    def __enter__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False


@pytest.mark.parametrize("name", ["e2e_train_b16", "swin_ft_b64_k8",
                                  "e2e_serve_ci"])
def test_a_traced_tiny_run_reads_its_span_metrics(name, monkeypatch):
    """A traced run of the tiny cell on the CPU prints every span metric
    of its cell; the phases nearly make up the host time they split."""
    from mvuld_tpu_torch.core import tracing
    monkeypatch.setattr(trace, "Traced", CpuTraced)
    tracing.reset()
    try:
        result, _, notes = run.measure(tiny.cell(name), M, 11, 1.0, True,
                                       torch.device("cpu"),
                                       time.perf_counter())
    finally:
        tracing.reset()
    want = {m for m, cells in SPAN_METRICS.items() if name in cells}
    # on the CPU a multi-step call is K eager steps: no static buffers to
    # load, so no step.input (the card's path alone)
    want.discard("step_input_ms.finetune")
    assert want <= set(result["metrics"])
    assert all(result["metrics"][m]["value"] > 0 for m in want
               if not m.startswith("feed_wait"))
    if name == "swin_ft_b64_k8":
        return
    shares = [float(n.rsplit("(", 1)[1].split(" %")[0]) for n in notes
              if "against the traced" in n]
    assert len(shares) == 1 and 80 <= shares[0] <= 100.5, notes
