"""Spans of the program's phases, recorded only while a profiler is open.

``with span("step.forward"): ...`` marks one phase of the trainer feed,
the train step or the serving loop. Tracing is on exactly while a
``torch.profiler`` (or ``torch.autograd.profiler``) profile is open
anywhere in the process; there is no setting of its own.

- Off, ``span`` returns one shared no-op context manager: one read of the
  profiler's process-wide flag (``torch.autograd.profiler.
  _is_profiler_enabled``, read through the module each time; the per-thread
  ``torch._C._autograd._profiler_enabled()`` reads false in a thread the
  profiler was not opened on), no clock, no allocation.
- On, the span enters a ``RecordFunction`` named ``"mvuld." + name``, so
  it sits in the trace on the thread that opened it, and on exit adds to
  the registry under ``name``: count, total seconds, first start and last
  end. The ``RecordFunction`` is operator-scoped
  (``torch._C._profiler._RecordFunctionFast``): a ``record_function`` is
  user-scoped, and the profiler copies a user scope onto the device's
  timeline as an event that readers of device time count as busy. The
  stamps are ``time.time_ns()``, the clock the profiler stamps its events
  on. A thread the profiler does not record (the ``Prefetcher``'s
  producer) is seen through the registry alone. A span that starts while
  tracing is off is not recorded, even if a profile opens before it ends,
  nor one that ends by an exception (the ``Prefetcher``'s pull that finds
  its source exhausted).

``snapshot()`` returns the registry, ``reset()`` clears it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_REGISTRY: Dict[str, List[int]] = {}     # name → [n, total ns, first, last]


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch._C._profiler._RecordFunctionFast("mvuld." + self.name)
        self.t0 = time.time_ns()
        self.rf.__enter__()
        return self

    def __exit__(self, exc_type, *exc):
        t1 = time.time_ns()
        self.rf.__exit__(exc_type, *exc)
        if exc_type is not None:
            return False
        t0 = self.t0
        with _LOCK:
            e = _REGISTRY.get(self.name)
            if e is None:
                _REGISTRY[self.name] = [1, t1 - t0, t0, t1]
            else:
                e[0] += 1
                e[1] += t1 - t0
                e[2] = min(e[2], t0)
                e[3] = max(e[3], t1)
        return False


def span(name: str):
    """A context manager marking the phase ``name`` (see the module's
    docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def snapshot() -> Dict[str, Dict]:
    """{name: {"n", "s", "first_ns", "last_ns"}} of the spans recorded
    since the last ``reset``."""
    with _LOCK:
        return {k: {"n": n, "s": ns / 1e9, "first_ns": a, "last_ns": b}
                for k, (n, ns, a, b) in _REGISTRY.items()}


def reset() -> None:
    with _LOCK:
        _REGISTRY.clear()
