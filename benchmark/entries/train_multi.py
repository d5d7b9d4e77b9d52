"""Entry ``train_multi``: SwinV2 fine-tuned K optimizer steps per call, as
``train_swin`` builds it with TRAIN.FUSED_STEPS K and ``train/harness.fit``
feeds it: [K, B, ...] superbatches stacked and page-locked in the port's
``Prefetcher`` thread, one ``MultiTrainStep`` call per superbatch (a CUDA
graph replay after the first call, which trains K eager steps and
captures).

Set-up builds the training once and makes its first call (the capture).
It then puts the same model, optimizer and generator back to the seeded
start in place (the graph reads those tensors) and makes the second call,
the first replay: its K steps are the checked steps the reference follows.
The same objects go on into the window.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict

import numpy as np
import torch

from benchmark.lib import program, trace, traffic, weights
from benchmark.lib.common import logs_at, sub_seeds, sync
from benchmark.reference import follow


class Entry:
    kind = "train"

    def __init__(self, cell: Dict, seed: int, device):
        self.cell, self.dev = cell, device
        self.m, self.t = cell["model"], cell["traffic"]
        self.w_seed, self.g_seed, self.d_seed = sub_seeds(seed, 3)
        self.B, self.K = self.t["batch"], self.t["fused_steps"]

    def _restart(self) -> None:
        """Parameters, optimizer state and generator back to the seeded
        start, in place."""
        named = dict(self.model.named_parameters())
        table = weights.make(weights.spec_of(named.items()), self.w_seed,
                             self.dev)
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(table[k])
            for t in self.opt.mu + self.opt.nu:
                t.zero_()
            self.opt.count_t.zero_()
        self.gen.manual_seed(self.g_seed)

    def setup(self) -> None:
        from mvuld_tpu_torch.data.loader import Prefetcher, pin_batch
        from mvuld_tpu_torch.parallel.mesh import step_generator
        from mvuld_tpu_torch.train.train_swin import build_swin_training

        t, dev = self.t, self.dev
        cuda = dev.type == "cuda"
        cfg = program.config(self.m)
        self.print_freq = cfg.PRINT_FREQ
        run = build_swin_training(cfg, dev, kernels=cuda)
        self.model = run.model
        program.load_weights(self.model, self.w_seed, dev)
        run.opt = self.opt = program.optimizer(cfg, self.model, t["lr"])
        self.multi = run.multi_step(self.K)
        self.gen = step_generator(None, dev, self.g_seed)
        self.pool = traffic.image_batches(t["pool_batches"], self.B,
                                          self.m["data"]["img_size"],
                                          self.d_seed, dev)
        self.stop = threading.Event()
        P, K = len(self.pool), self.K

        def source():
            for j in itertools.count():
                if self.stop.is_set():
                    return
                group = [self.pool[(j * K + i) % P] for i in range(K)]
                yield {k: np.stack([b[k] for b in group]) for k in group[0]}

        self.feed = iter(Prefetcher(source(), pin_batch if cuda else None,
                                    depth=2))

        def call():
            return self.multi(next(self.feed), self.gen)

        self.call = call
        call()                                  # K eager steps, the capture
        self._restart()
        metrics = call()                        # the first replay
        self.readings = {
            "losses": [float(x) for x in metrics["loss"].tolist()],
            "grad1": None, "bn1": None,
            "update": program.update_norms(self.model, self.w_seed, dev),
            "grad_rms": program.grad_rms_norms(self.opt)}
        self.calls = 2
        sync(dev)

    def window(self, seconds: float, traced: bool) -> Dict:
        spans, tw, K = [], None, self.K

        def timed():
            """One call, as ``fit`` makes it: the last step's loss read on
            the host only where ``fit`` logs."""
            a = time.perf_counter()
            out = self.call()
            spans.append(time.perf_counter() - a)
            if logs_at((self.calls + len(spans) - 1) * K, K, self.print_freq):
                float(out["loss"][-1])

        t0 = time.perf_counter()
        if traced:
            with trace.Traced() as tw:
                for _ in range(self.t["trace_calls"]):
                    timed()
        while time.perf_counter() - t0 < seconds:
            timed()
        sync(self.dev)
        t1 = time.perf_counter()
        calls = len(spans)
        self.calls += calls
        steps = calls * self.K
        tr = None
        if tw is not None:
            tr = trace.reduce(tw.prof, tw.wall_s)
            tr["steps"] = self.t["trace_calls"] * self.K
        return {"kind": "train", "steps": steps, "samples": steps * self.B,
                "window_s": t1 - t0,
                "host_step_s": [s / self.K for s in spans],
                "images": steps * self.B,
                "traced_images": tr["steps"] * self.B if tr else 0,
                "trace": tr, "attempted": steps, "failed": 0}

    def close(self) -> None:
        self.stop.set()
        for _ in self.feed:
            pass
        del self.model, self.opt, self.multi, self.call, self.feed
        self.gen = None

    def checked_batches(self):
        P = len(self.pool)
        return [{k: torch.as_tensor(v).to(self.dev)
                 for k, v in self.pool[(self.K + i) % P].items()}
                for i in range(self.K)]

    def reference(self, precision: str = "fp32", half: bool = False) -> Dict:
        return follow.follow(self.m, self.t, self.w_seed, self.g_seed,
                             self.checked_batches(), self.dev, precision,
                             half)
