"""Process-aware logger (reference: mvuld/logger.py:15-41), a copy of
``mvuld_tpu/core/logger.py``.

In the reference each DDP rank writes ``log_rank{r}.txt`` and only rank 0 logs
to the console; the port trains in one process, rank 0.
"""

from __future__ import annotations

import functools
import logging
import os
import sys
import time


@functools.lru_cache()
def create_logger(output_dir: str = "", dist_rank: int = 0, name: str = "mvuld_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    fmt = "[%(asctime)s %(name)s] (%(filename)s %(lineno)d): %(levelname)s %(message)s"
    if dist_rank == 0:
        console = logging.StreamHandler(sys.stdout)
        console.setLevel(logging.DEBUG)
        console.setFormatter(logging.Formatter(fmt=fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(console)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, f"log_rank{dist_rank}.txt"), mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt=fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(fh)
    return logger


class WindowRate:
    """Per-window throughput meter: ``read()`` returns samples accumulated
    since the previous ``read()`` divided by the wall time since then.

    The naive alternative — cumulative samples over elapsed-since-t0 —
    misreports under an async dispatch queue: the host sync at each print
    absorbs the whole window's device lag, so only window-relative
    accounting gives the true steady-state rate.  ``clock`` is injectable
    for tests."""

    def __init__(self, clock=time.time):
        self._clock = clock
        self._t = clock()
        self._n = 0
        self.val = 0.0

    def add(self, n: int):
        self._n += int(n)

    def read(self) -> float:
        now = self._clock()
        self.val = self._n / max(now - self._t, 1e-9)
        self._t = now
        self._n = 0
        return self.val


class AverageMeter:
    """Running average tracker (reference uses timm's AverageMeter in main.py)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0
