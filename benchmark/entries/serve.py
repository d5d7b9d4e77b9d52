"""Entry ``serve``: P(vul) for requests of featurised functions through
``train/predict.serve`` (chunks of at most the cell's max batch, a tail
chunk padded to its power-of-two bucket), on the model as the serving CLI
builds it, by one client in a closed loop: each request is sent when the
previous one has its answers on the host.

Requests are runs of rows of a pool the benchmark makes from the seed
(views, so sending one copies nothing on the host). Set-up serves every
bucket shape once. Host featurisation (Joern, rendering) is outside.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import program, trace, traffic
from benchmark.lib.common import sub_seeds, sync
from benchmark.reference import follow


class Entry:
    kind = "serve"

    def __init__(self, cell: Dict, seed: int, device):
        self.cell, self.dev = cell, device
        self.m, self.t = cell["model"], cell["traffic"]
        self.w_seed, self.d_seed, self.s_seed = sub_seeds(seed, 3)

    def setup(self) -> None:
        from mvuld_tpu_torch.train.predict import serve

        t, dev = self.t, self.dev
        _, self.model = program.e2e_model(self.m, dev, None,
                                          kernels=dev.type == "cuda")
        program.load_weights(self.model, self.w_seed, dev)
        self.model.eval()
        pool = traffic.rows(t, self.m["data"], t["pool_rows"], self.d_seed,
                            dev)
        pool.pop("label")
        self.pool = pool
        self.requests = traffic.requests(t, t["pool_rows"], self.d_seed,
                                         t["max_requests"])
        self.serve = lambda lo, n: serve(
            self.model, {k: v[lo:lo + n] for k, v in self.pool.items()},
            t["max_batch"], dev)
        b = 1
        while b <= t["max_batch"]:               # every bucket shape
            self.serve(0, b)
            b *= 2
        sync(dev)
        self.next = 0

    def _send(self, out: List) -> None:
        lo, n = self.requests[self.next % len(self.requests)]
        self.next += 1
        a = time.perf_counter()
        p = self.serve(lo, n)
        out.append((lo, n, time.perf_counter() - a, p))

    def window(self, seconds: float, traced: bool) -> Dict:
        done: List = []
        tw, traced_n = None, 0
        t0 = time.perf_counter()
        if traced:
            with trace.Traced() as tw:
                for _ in range(self.t["trace_requests"]):
                    self._send(done)
            traced_n = len(done)
        while time.perf_counter() - t0 < seconds:
            self._send(done)
        t1 = time.perf_counter()
        tr = trace.reduce(tw.prof, tw.wall_s) if tw is not None else None
        self.done = done
        return {"kind": "serve", "window_s": t1 - t0,
                "latencies_s": [d[2] for d in done],
                "functions": sum(d[1] for d in done),
                "requests": [(d[0], d[1]) for d in done],
                "traced_requests": [(d[0], d[1]) for d in done[:traced_n]],
                "pool": self.pool, "trace": tr,
                "attempted": len(done), "failed": 0}

    def close(self) -> None:
        del self.model, self.serve

    def sample(self) -> List[int]:
        """Indices of served requests to compare, drawn from the seed: the
        longest, then one of every other size served (so every tail chunk
        and bucket shape the window padded), then others up to the cell's
        count of functions."""
        done = self.done
        order = [int(i) for i in
                 np.random.default_rng(self.s_seed).permutation(len(done))]
        longest = max(range(len(done)), key=lambda i: done[i][1])
        pick, sizes = [longest], {done[longest][1]}
        for i in order:
            if done[i][1] not in sizes:
                pick.append(i)
                sizes.add(done[i][1])
        n = sum(done[i][1] for i in pick)
        for i in order:
            if n >= self.t["sample_functions"]:
                break
            if i not in pick:
                pick.append(i)
                n += done[i][1]
        return pick

    def reference(self, precision: str = "fp32", half: bool = False) -> Dict:
        """P(vul) on both sides for the sampled requests' functions."""
        pick = self.sample()
        rows = np.concatenate([np.arange(self.done[i][0],
                                         self.done[i][0] + self.done[i][1])
                               for i in pick])
        served = np.concatenate([self.done[i][3] for i in pick])
        uniq, inv = np.unique(rows, return_inverse=True)
        dev_rows = {k: torch.as_tensor(v[uniq]).to(self.dev)
                    for k, v in self.pool.items()}
        ref = follow.probs(self.m, self.w_seed, dev_rows, self.t["blocks"],
                           self.dev, precision).cpu().numpy()[inv]
        return {"served": served, "reference": ref,
                "functions": int(len(rows)), "requests": len(pick)}
