"""Entry ``train_multi_moe``: Swin-MoE fine-tuned K optimizer steps per
call, as ``train_multi`` drives SwinV2 (``train_swin`` with MODEL.TYPE
swin_moe and TRAIN.FUSED_STEPS K: one CUDA graph replay per call after
the capture), with three differences:

* the weight table is ``reference/follow_moe.weight_table`` (the MoE
  leaves on their true fan-in), on both sides: the seeded start the
  checked steps begin from, and the start their update is measured from;
* the reference is ``reference/follow_moe.follow``;
* the window resets the MoE layers' device counters
  (``models/moe.reset_routing_counters``) before it starts and puts their
  sums after it under ``raw["moe"]``: assignments routed, kept, and the
  capacity slots the experts ran over.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.entries.train_multi import Entry as _Base
from benchmark.lib import checks, weights
from benchmark.reference import follow_moe


class Entry(_Base):

    def _table(self):
        named = dict(self.model.named_parameters())
        return named, follow_moe.weight_table(weights.spec_of(named.items()),
                                              self.w_seed, self.dev)

    def _restart(self) -> None:
        named, table = self._table()
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(table[k])
            for t in self.opt.mu + self.opt.nu:
                t.zero_()
            self.opt.count_t.zero_()
        self.gen.manual_seed(self.g_seed)

    def setup(self) -> None:
        # a program without the MoE's counters cannot run this cell: fail
        # before the build
        from mvuld_tpu_torch.models.moe import (reset_routing_counters,
                                                routing_counters)
        self.counters = (reset_routing_counters, routing_counters)
        super().setup()
        named, start = self._table()
        self.readings["update"] = checks.change_norms(named, start)
        del start

    def window(self, seconds: float, traced: bool) -> Dict:
        reset, read = self.counters
        reset(self.model)
        raw = super().window(seconds, traced)
        raw["moe"] = read(self.model)
        return raw

    def reference(self, precision: str = "fp32", half: bool = False) -> Dict:
        return follow_moe.follow(self.m, self.t, self.w_seed, self.g_seed,
                                 self.checked_batches(), self.dev, precision,
                                 half)
