"""Entry ``train_eager``: the tri-modal model trained one batch per call,
as ``train/harness.fit`` drives ``train_e2e``: host batches page-locked by
the port's ``Prefetcher`` thread (``pin_batch``), copied by ``to_device``
and trained by ``core/train_state.train_step``.

Set-up builds the model, the optimizer and the step generator once,
drives them through the checked steps by that same feed and call (the
reference follows those steps), and hands the same objects to the window.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict

import torch

from benchmark.lib import program, trace, traffic
from benchmark.lib.common import logs_at, sub_seeds, sync
from benchmark.reference import follow


class Entry:
    kind = "train"

    def __init__(self, cell: Dict, seed: int, device):
        self.cell, self.dev = cell, device
        self.m, self.t = cell["model"], cell["traffic"]
        self.w_seed, self.g_seed, self.d_seed = sub_seeds(seed, 3)
        self.B = self.t["batch"]

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from mvuld_tpu_torch.core.train_state import model_inputs, train_step
        from mvuld_tpu_torch.data.loader import Prefetcher, pin_batch
        from mvuld_tpu_torch.parallel.mesh import step_generator
        from mvuld_tpu_torch.train.harness import to_device

        t, dev = self.t, self.dev
        cuda = dev.type == "cuda"
        self.cfg, self.model = program.e2e_model(
            self.m, dev, t["node_capacity"], kernels=cuda)
        program.load_weights(self.model, self.w_seed, dev)
        self.opt = program.optimizer(self.cfg, self.model, t["lr"])
        self.gen = step_generator(None, dev, self.g_seed)
        self.pool = traffic.batches(t, self.m["data"], t["pool_batches"],
                                    self.B, self.d_seed, dev)
        self.stop = threading.Event()

        def source():
            for b in itertools.cycle(self.pool):
                if self.stop.is_set():
                    return
                yield b

        self.feed = iter(Prefetcher(source(), pin_batch if cuda else None,
                                    depth=2))

        def step():
            b = to_device(next(self.feed), dev)
            return train_step(self.model, self.opt, b, self.gen,
                              t["label_smoothing"], model_inputs)

        self.step = step
        losses, grad1, bn1 = [], None, None
        for i in range(t["checked_steps"]):
            losses.append(step()["loss"])
            if i == 0:
                grad1 = program.first_grad_norms(self.opt)
                bn1 = program.bn_norms(self.model)
        self.readings = {
            "losses": [float(x) for x in losses], "grad1": grad1,
            "update": program.update_norms(self.model, self.w_seed, dev),
            "grad_rms": program.grad_rms_norms(self.opt),
            "bn1": bn1}
        self.consumed = t["checked_steps"]
        sync(dev)

    # ------------------------------------------------------------ window
    def window(self, seconds: float, traced: bool) -> Dict:
        spans, first, tw = [], self.consumed, None
        freq = self.cfg.PRINT_FREQ

        def timed():
            """One call, as ``fit`` makes it: the loss read on the host
            only where ``fit`` logs."""
            a = time.perf_counter()
            out = self.step()
            spans.append(time.perf_counter() - a)
            if logs_at(first + len(spans) - 1, 1, freq):
                float(out["loss"])

        t0 = time.perf_counter()
        if traced:
            with trace.Traced() as tw:
                for _ in range(self.t["trace_steps"]):
                    timed()
        while time.perf_counter() - t0 < seconds:
            timed()
        sync(self.dev)
        t1 = time.perf_counter()
        steps = len(spans)
        self.consumed += steps
        tr = None
        if tw is not None:
            tr = trace.reduce(tw.prof, tw.wall_s)
            tr["steps"] = self.t["trace_steps"]
        P = len(self.pool)
        used = [self.pool[(first + i) % P] for i in range(steps)]
        return {"kind": "train", "steps": steps, "samples": steps * self.B,
                "window_s": t1 - t0, "host_step_s": spans,
                "batches": used, "traced_batches": used[:tr["steps"]] if tr
                else [], "trace": tr, "attempted": steps, "failed": 0}

    def close(self) -> None:
        self.stop.set()
        for _ in self.feed:           # the thread ends at its next batch
            pass
        del self.model, self.opt, self.step, self.feed
        self.gen = None

    # ------------------------------------------------------------- check
    def checked_batches(self):
        n = self.t["checked_steps"]
        return [{k: torch.as_tensor(v).to(self.dev) for k, v in b.items()}
                for b in self.pool[:n]]

    def reference(self, precision: str = "fp32", half: bool = False) -> Dict:
        return follow.follow(self.m, self.t, self.w_seed, self.g_seed,
                             self.checked_batches(), self.dev, precision,
                             half)
