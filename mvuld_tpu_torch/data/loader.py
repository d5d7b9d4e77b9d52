"""Host-side batching: the torch DataLoader/DistributedSampler replacement,
a copy of ``mvuld_tpu/data/loader.py``.

The reference shards data with DistributedSampler and reshuffles with
``sampler.set_epoch(epoch)`` (mvuld/data/bigvul_dataset.py:163-205,
main.py:205). Here one host feeds one card; epoch shuffling is seeded with
(seed, epoch), the JAX package's order, for exact reproducibility.

Two iteration modes mirror the reference:
  * train: shuffle, drop_last,
  * eval: sequential, last partial batch padded + a validity mask so metric
    code can drop padding (the reference gathers all logits and slices).

``Prefetcher`` runs a batch iterator in a background thread (the trainer
harness wraps every epoch's batches in one); ``pin_batch`` copies a host
batch into page-locked memory there, so that the training thread's copy
to the card is an asynchronous DMA.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from mvuld_tpu_torch.core.tracing import span


class ArrayDataset:
    """A dataset backed by a dict of equal-length sequences / arrays, with an
    optional per-item transform (e.g. image decode + augment)."""

    def __init__(self, columns: Dict[str, Sequence],
                 transform: Optional[Callable[[Dict, np.random.RandomState],
                                              Dict]] = None):
        lens = {k: len(v) for k, v in columns.items()}
        assert len(set(lens.values())) == 1, f"ragged columns: {lens}"
        self.columns = columns
        self.transform = transform
        self.n = next(iter(lens.values()))

    def __len__(self) -> int:
        return self.n

    def get(self, idx: int, rng: Optional[np.random.RandomState] = None
            ) -> Dict:
        item = {k: v[idx] for k, v in self.columns.items()}
        if self.transform is not None:
            item = self.transform(item, rng or np.random.RandomState(0))
        return item


def _collate(items) -> Dict[str, np.ndarray]:
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else np.asarray(vals)
    return out


def train_batches(ds: ArrayDataset, batch_size: int, epoch: int,
                  seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.RandomState(seed + epoch * 1000003)
    order = rng.permutation(len(ds))
    n_batches = len(ds) // batch_size
    for b in range(n_batches):
        idx = order[b * batch_size:(b + 1) * batch_size]
        yield _collate([ds.get(int(i), rng) for i in idx])


def eval_batches(ds: ArrayDataset, batch_size: int
                 ) -> Iterator[Dict[str, np.ndarray]]:
    n_batches = math.ceil(len(ds) / batch_size)
    for b in range(n_batches):
        idx = list(range(b * batch_size, min((b + 1) * batch_size, len(ds))))
        items = [ds.get(i) for i in idx]
        batch = _collate(items)
        valid = np.zeros(batch_size, np.float32)
        valid[: len(idx)] = 1.0
        if len(idx) < batch_size:           # pad to static shape
            pad = batch_size - len(idx)
            batch = {k: np.concatenate([v] + [v[-1:]] * pad) for k, v in batch.items()}
        batch["_valid"] = valid
        yield batch


def steps_per_epoch(n: int, batch_size: int) -> int:
    return n // batch_size


class Prefetcher:
    """Background-thread prefetch over a batch iterator (the JAX package's
    ``Prefetcher``; the reference's DataLoader(num_workers=8)): a producer
    thread pulls from ``it``, applies ``place_fn`` and keeps up to
    ``depth`` items queued, so host input work (decode, augmentation,
    superbatch stacking) overlaps the device's steps. ``produced`` counts
    the items made; an exception in the producer reaches the consumer.
    Spans (``core/tracing.py``): ``feed.make`` in the producer around
    pulling and placing each item (not the put into a full queue),
    ``feed.wait`` in the consumer around each get."""

    _SENTINEL = object()

    def __init__(self, it, place_fn: Optional[Callable] = None,
                 depth: int = 2):
        import queue
        import threading
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None
        self.produced = 0

        def run():
            try:
                src = iter(it)
                while True:
                    with span("feed.make"):
                        item = next(src)
                        if place_fn:
                            item = place_fn(item)
                    self._q.put(item)
                    self.produced += 1
            except StopIteration:
                pass
            except BaseException as e:   # noqa: BLE001 — to the consumer
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            with span("feed.wait"):
                item = self._q.get()
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item


def pin_batch(batch: Dict) -> Dict:
    """A host batch's arrays as page-locked CPU tensors (same dtypes and
    values), for ``.to(device, non_blocking=True)``."""
    import torch
    return {k: torch.as_tensor(np.asarray(v)).pin_memory()
            for k, v in batch.items()}
