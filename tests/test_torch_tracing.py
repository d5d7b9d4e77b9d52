"""The port's spans (``mvuld_tpu_torch/core/tracing.py``) on the CPU.

With no profiler open a span is one shared no-op and records nothing;
under ``torch.profiler`` the train step, the ``Prefetcher`` and the
serving loop record their phases in the registry and, on the thread that
opened the profile, as ``mvuld.*`` events stamped on the profiler's own
clock (``time.time_ns()``); the step's numbers do not depend on it. Tiny
models: a two-layer MLP trained by ``train_step``, and a stand-in for the
tri-modal model's serving call.
"""

import threading

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from mvuld_tpu_torch.core import tracing

STEP = ("step.forward", "step.backward", "step.optimizer")
SERVE = ("serve.input", "serve.forward", "serve.fetch")


@pytest.fixture(autouse=True)
def _empty_registry():
    tracing.reset()
    yield
    tracing.reset()


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc0, self.fc1 = nn.Linear(4, 8), nn.Linear(8, 2)

    def forward(self, x, train=False, gen=None):
        return self.fc1(torch.relu(self.fc0(x)))


class ServeToy(nn.Module):
    """``predict.serve``'s call signature; logits from the image."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(3, 2)

    def forward(self, func_ids, node_ids, image, pos, adj, node_mask,
                line_rows=None):
        return self.fc(image.float().mean((2, 3)))

    def line_batch(self, slots, line_rows):
        return line_rows


def _train_setup(seed=0):
    from mvuld_tpu_torch.core.optim import Optimizer

    torch.manual_seed(seed)
    model = Toy()
    named = list(model.named_parameters())
    opt = Optimizer(named, {n: n.endswith("weight") for n, _ in named},
                    lambda count: 1e-2, weight_decay=0.01, clip=1.0)
    rng = np.random.RandomState(seed)
    batch = {"x": torch.tensor(rng.randn(8, 4).astype(np.float32)),
             "label": torch.tensor(rng.randint(0, 2, 8))}
    return model, opt, batch


def _step(model, opt, batch):
    from mvuld_tpu_torch.core.train_state import train_step
    return train_step(model, opt, batch, None, 0.1,
                      lambda b: {"x": b["x"]})


def _serve(n=10, batch_size=4):
    from mvuld_tpu_torch.train.predict import serve
    rng = np.random.RandomState(1)
    arrs = {"func_ids": rng.randint(0, 9, (n, 6)).astype(np.int32),
            "node_ids": rng.randint(0, 9, (n, 3, 2)).astype(np.int32),
            "image": rng.randn(n, 3, 8, 8).astype(np.float32),
            "pos": rng.randn(n, 3, 4).astype(np.float32),
            "adj": np.ones((n, 3, 3), np.int8),
            "node_mask": np.ones((n, 3), np.float32)}
    torch.manual_seed(0)
    return serve(ServeToy(), arrs, batch_size, torch.device("cpu"))


def _prefetch(n=3):
    """Take ``n`` items of a ``Prefetcher`` over ``n`` items; the producer
    has ended when this returns."""
    from mvuld_tpu_torch.data.loader import Prefetcher
    pf = Prefetcher(iter(range(n)), lambda i: {"x": np.full(4, i)},
                    depth=n + 1)
    it = iter(pf)
    got = [int(next(it)["x"][0]) for _ in range(n)]
    pf._thread.join(timeout=30)
    assert not pf._thread.is_alive()
    return got, it


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_span_is_the_shared_noop_and_records_nothing():
    assert tracing.span("a") is tracing.span("b") is tracing._OFF
    model, opt, batch = _train_setup()
    _step(model, opt, batch)
    got, it = _prefetch()
    assert got == [0, 1, 2] and list(it) == []
    _serve()
    assert tracing.snapshot() == {}


def test_train_step_records_each_phase_once():
    model, opt, batch = _train_setup()
    with _cpu_profile() as prof:
        _step(model, opt, batch)
    snap = tracing.snapshot()
    assert sorted(snap) == sorted(STEP)
    for name in STEP:
        s = snap[name]
        assert s["n"] == 1 and s["s"] > 0
        assert s["last_ns"] - s["first_ns"] == pytest.approx(s["s"] * 1e9,
                                                             abs=1)
    names = [e.name for e in prof.events()]
    for name in STEP:
        assert names.count("mvuld." + name) == 1
    # operator-scoped: a user scope would be copied onto the device's
    # timeline, where it would count as device work
    assert not any(e.is_user_annotation for e in prof.events()
                   if e.name.startswith("mvuld."))
    assert (snap["step.forward"]["last_ns"]
            <= snap["step.backward"]["first_ns"]
            <= snap["step.backward"]["last_ns"]
            <= snap["step.optimizer"]["first_ns"])


def test_prefetcher_records_main_thread_waits_and_producer_makes():
    with _cpu_profile() as prof:
        got, it = _prefetch(3)
    assert got == [0, 1, 2]
    snap = tracing.snapshot()
    assert snap["feed.wait"]["n"] == 3
    assert snap["feed.make"]["n"] == 3    # the pull that found the end: none
    assert [e.name for e in prof.events()].count("mvuld.feed.wait") == 3
    list(it)                              # drained with the profiler closed
    assert tracing.snapshot() == snap


def test_serve_records_each_phase_once_per_chunk():
    with _cpu_profile() as prof:
        _serve(n=10, batch_size=4)        # chunks of 4, 4 and 2 (bucket 2)
    snap = tracing.snapshot()
    assert sorted(snap) == sorted(SERVE)
    assert all(snap[name]["n"] == 3 for name in SERVE)
    names = [e.name for e in prof.events()]
    assert all(names.count("mvuld." + name) == 3 for name in SERVE)


def test_span_stamps_match_the_profilers_events():
    """One span of each phase: its registry stamps on the clock of the
    profiler's events (kineto's, ``time.time_ns()``), within 1 ms."""
    model, opt, batch = _train_setup()
    with _cpu_profile() as prof:
        _step(model, opt, batch)
        with tracing.span("probe"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    snap = tracing.snapshot()
    events = {e.name()[len("mvuld."):]: e
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("mvuld.")}
    assert sorted(events) == sorted(snap)
    for name, e in events.items():
        assert abs(snap[name]["first_ns"] - e.start_ns()) < 1e6, name
        assert abs(snap[name]["last_ns"] - e.end_ns()) < 1e6, name


def test_flag_is_seen_in_a_worker_thread():
    seen = []
    with _cpu_profile():
        t = threading.Thread(target=lambda: seen.append(
            tracing.span("worker") is not tracing._OFF))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [True]
    assert tracing.span("after") is tracing._OFF


def test_spans_started_before_the_profile_or_raising_are_not_recorded():
    outer = tracing.span("before")
    with outer:
        with _cpu_profile():
            with pytest.raises(KeyError):
                with tracing.span("raises"):
                    raise KeyError("x")
    assert tracing.snapshot() == {}


def test_train_step_is_the_same_with_and_without_the_profiler():
    runs = []
    for traced in (False, True):
        model, opt, batch = _train_setup(seed=3)
        outs = []
        for _ in range(2):
            if traced:
                with _cpu_profile():
                    outs.append(_step(model, opt, batch))
            else:
                outs.append(_step(model, opt, batch))
        runs.append(([float(o["loss"]) for o in outs],
                     [p.detach().clone() for p in model.parameters()]))
    (loss0, p0), (loss1, p1) = runs
    assert loss0 == loss1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
