"""The port's ``Prefetcher`` and TRAIN.BEST_FETCH "async" against the JAX
package, on the CPU.

- ``Prefetcher``: the items of JAX's ``Prefetcher`` over the same source
  and ``place_fn``, in order; the producer runs ahead of a slow consumer
  (item i + 2 made before item i is consumed); an exception in the
  producer reaches the consumer after the items before it
  (``tests/test_loader_edge.py``'s cases).
- ``fit`` with BEST_FETCH "async" against "sync" (JAX:
  ``tests/test_best_state.py::test_fit_best_fetch_async``): with the train
  step and the evaluation replaced by stubs that make epochs 0 and 1
  improve and the later ones degrade, both write the same best-F1
  checkpoint files with equal tensors, return epoch 1 as the best and
  leave the model at its epoch-1 state, as JAX's async path does. On the
  CPU the async snapshot's copies are plain ones; the card's pinned,
  non-blocking copies run in ``chip_smoke.py``.
"""

import os
import time

import numpy as np
import pytest
import torch


def test_prefetcher_yields_what_jax_yields():
    from mvuld_tpu.data.loader import Prefetcher as JPrefetcher
    from mvuld_tpu_torch.data.loader import Prefetcher

    def place(x):
        return {"x": np.full(3, x), "sq": x * x}

    got = list(Prefetcher(iter(range(7)), place_fn=place, depth=3))
    want = list(JPrefetcher(iter(range(7)), place_fn=place, depth=3))
    assert [g["sq"] for g in got] == [w["sq"] for w in want] == \
        [i * i for i in range(7)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"], w["x"])


def test_prefetcher_overlaps_and_preserves_order():
    from mvuld_tpu_torch.data.loader import Prefetcher

    pf = Prefetcher(iter(range(5)), place_fn=lambda x: (x, time.time()),
                    depth=2)
    got = []
    for x, made in pf:
        time.sleep(0.05)                # a device step
        got.append((x, made, time.time()))
    assert [g[0] for g in got] == list(range(5))
    assert pf.produced == 5
    for i in range(len(got) - 2):
        assert got[i + 2][1] < got[i][2], (i, got)


def test_prefetcher_propagates_errors():
    from mvuld_tpu_torch.data.loader import Prefetcher

    def bad():
        yield 1
        raise ValueError("boom")

    it = iter(Prefetcher(bad()))
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def _best_fetch_run(tmp_path, fetch, monkeypatch):
    """``fit`` over 2 steps an epoch, 4 epochs: each step adds 1 to the
    model's parameter and counts an optimizer step; the evaluation's F1 is
    0.5 after epoch 0, 1.0 after epoch 1 and 0 after."""
    from mvuld_tpu_torch.config import default_config
    from mvuld_tpu_torch.core.optim import Optimizer
    from mvuld_tpu_torch.data.loader import ArrayDataset
    from mvuld_tpu_torch.train import harness

    cfg = default_config()
    cfg.DATA.BATCH_SIZE = 8
    cfg.TRAIN.EPOCHS = 4
    cfg.TRAIN.EARLY_STOP_PATIENCE = 10
    cfg.TRAIN.BEST_FETCH = fetch
    cfg.PRINT_FREQ = 1000
    cfg.SAVE_FREQ = 0
    model = torch.nn.Linear(1, 1, bias=False)
    with torch.no_grad():
        model.weight.zero_()
    opt = Optimizer(list(model.named_parameters()), {"weight": False},
                    lambda c: 0.0)

    def train_step(model, opt, batch, gen, *args, **kw):
        with torch.no_grad():
            model.weight.add_(1.0)
        opt.count_t.add_(1)
        return {"loss": torch.zeros(())}

    def run_eval(model, *args, **kw):
        f1 = {2: 0.5, 4: 1.0}.get(int(model.weight.detach()), 0.0)
        return {"f1": f1, "acc": f1, "precision": f1, "recall": f1,
                "roc_auc": f1, "pr_auc": f1}

    monkeypatch.setattr(harness, "train_step", train_step)
    monkeypatch.setattr(harness, "run_eval", run_eval)
    n = 16
    ds = ArrayDataset({"x": np.zeros((n, 1), np.float32),
                       "label": np.arange(n, dtype=np.int32) % 2})
    out = str(tmp_path / fetch)
    res = harness.fit(cfg=cfg, model=model, opt=opt, train_ds=ds, val_ds=ds,
                      device=torch.device("cpu"), test_ds=ds,
                      output_dir=out)
    return res, model, out


def test_fit_best_fetch_async_writes_what_sync_writes(tmp_path, monkeypatch):
    from mvuld_tpu_torch.core.checkpoint import (load_checkpoint,
                                                 resume_bestf1_helper)

    runs = {f: _best_fetch_run(tmp_path, f, monkeypatch)
            for f in ("sync", "async")}
    files = {}
    for fetch, (res, model, out) in runs.items():
        assert res["best_epoch"] == 1 and res["best_f1"] == 1.0
        assert float(model.weight.detach()) == 4.0    # the epoch-1 state
        best = os.path.join(out, "checkpoint-best-f1")
        files[fetch] = sorted(os.listdir(best))
        tree = load_checkpoint(resume_bestf1_helper(out))
        assert tree["epoch"] == 1 and tree["step"] == 4
        assert float(tree["params"]["weight"]) == 4.0
        assert tree["opt_state"]["count"] == 4
    assert files["sync"] == files["async"] == ["best_f1_epoch_0",
                                               "best_f1_epoch_1"]
    for name in files["sync"]:
        a, b = (load_checkpoint(os.path.join(runs[f][2], "checkpoint-best-f1",
                                             name))
                for f in ("sync", "async"))
        assert a.keys() == b.keys()
        assert (a["step"], a["epoch"], a["best_f1"]) == \
            (b["step"], b["epoch"], b["best_f1"])
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k])
        for k in ("mu", "nu"):
            for x, y in zip(a["opt_state"][k], b["opt_state"][k]):
                assert torch.equal(x, y)
