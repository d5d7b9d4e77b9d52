"""Training harness: epoch loop, validation, best-F1 checkpointing.

Counterpart of ``mvuld_tpu/train/harness.py`` (reference mvuld/main.py
:204-241, main_bigvul.py:231-283): per-epoch train pass, validation with
the full metric suite (F1@0.5, PR-AUC, ROC-AUC), best-F1 checkpoint and
early stop, periodic epoch checkpoints, the resume ladder, and
``history.json``. Training throughput is read with the WindowRate meter
(samples since the last print over the time since then).

Batches come from ``data/loader.py`` on the host; ``to_device`` turns
each into device tensors. With ``device_data`` (TRAIN.DEVICE_DATA /
DEVICE_EVAL) a split's columns already live on the device and its host
batches carry only row indices ("idx"), gathered on the device.

Every epoch's host batches come through a ``Prefetcher`` thread, which
runs ``batch_hook``, stacks superbatches and, for the card, copies each
batch into page-locked memory (``data/loader.pin_batch``) while the device
trains; the training thread only issues the asynchronous copies to the
device. With
``multi_step`` (``core/train_state.make_multi_train_step``) and
``fused_steps`` K > 1, K host batches are stacked into a [K, B, ...]
superbatch and trained in one call (a CUDA graph replay on the card); the
epoch's remainder trains one batch at a time.

TRAIN.BEST_FETCH "async": an improvement of the validation F1 starts
non-blocking copies of the state into pinned host buffers behind a CUDA
event; the snapshot's checkpoint is written at the next improvement or
after the loop, the same files as "sync" writes.

With a ``mesh`` (``parallel/mesh.py``) every rank reads the same global
batches, keeps its block of rows (after ``batch_hook``, so mixup sees the
global batch; a superbatch's rows per step) and steps with the gradients
averaged over dp; evaluation shards its batches the same way and gathers
the logits. Only the primary rank writes the config, checkpoints and
``history.json``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mvuld_tpu_torch.core.checkpoint import (restore, resume_ladder,
                                             save_checkpoint)
from mvuld_tpu_torch.core.logger import AverageMeter, WindowRate, create_logger
from mvuld_tpu_torch.core.metrics import format_metrics, get_metrics_logits
from mvuld_tpu_torch.core.train_state import (EarlyStopper, Inputs,
                                              eval_step, model_inputs,
                                              train_step)
from mvuld_tpu_torch.data.loader import (ArrayDataset, Prefetcher,
                                         eval_batches, pin_batch,
                                         train_batches)


def to_device(batch: Dict[str, np.ndarray], device,
              device_data: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
    """Host batch → device tensors; an index batch gathers its rows from
    ``device_data``."""
    if device_data is not None:
        idx = torch.as_tensor(batch["idx"], device=device).long()
        out = {k: v[idx] for k, v in device_data.items()}
        if "label" in batch and "label" not in out:
            out["label"] = torch.as_tensor(batch["label"], device=device)
        return out
    return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
            .to(device, non_blocking=True) for k, v in batch.items()}


def run_eval(model, ds: ArrayDataset, batch_size: int, device,
             device_data=None, inputs: Inputs = model_inputs, mesh=None
             ) -> Dict[str, float]:
    """Logits over the eval set (the padded final batch masked out) and
    the metric suite on the host."""
    from mvuld_tpu_torch.parallel.mesh import gather_batch, shard_batch
    all_logits, all_labels = [], []
    for batch in eval_batches(ds, batch_size):
        valid = batch.pop("_valid")
        labels = np.asarray(batch["label"])
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        logits = eval_step(model, to_device(batch, device, device_data),
                           inputs)
        if mesh is not None:
            logits = gather_batch(mesh, logits)
        keep = valid > 0
        all_logits.append(logits.float().cpu().numpy()[keep])
        all_labels.append(labels[keep])
    return get_metrics_logits(np.concatenate(all_labels),
                              np.concatenate(all_logits))


def _snapshot(model, opt, full: bool, non_blocking: bool = False) -> Dict:
    """Host copy of the state (the best-F1 snapshot); ``_finish`` makes it
    a checkpoint tree. ``non_blocking``: CUDA tensors go to pinned host
    buffers by copies on the stream, and a CUDA event marks their end."""
    def host(t):
        t = t.detach()
        if non_blocking and t.is_cuda:
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t, non_blocking=True)
        return t.cpu().clone()

    opt_state = None
    if full:
        opt_state = {"count": host(opt.count_t),
                     "mini_step": host(opt.mini_step_t),
                     **{k: [host(t) for t in getattr(opt, k)]
                        for k in ("mu", "nu", "acc")}}
    tree = {"params": {k: host(v) for k, v in model.state_dict().items()},
            "opt_state": opt_state, "step": host(opt.count_t)}
    if non_blocking and opt.count_t.is_cuda:
        tree["_done"] = torch.cuda.Event()
        tree["_done"].record()
    return tree


def _finish(tree: Dict) -> Dict:
    """Wait for a snapshot's copies; the step counters as Python ints."""
    done = tree.pop("_done", None)
    if done is not None:
        done.synchronize()
    tree["step"] = int(tree["step"])
    if tree["opt_state"] is not None:
        for k in ("count", "mini_step"):
            tree["opt_state"][k] = int(tree["opt_state"][k])
    return tree


def fit(*, cfg, model, opt, train_ds: ArrayDataset, val_ds: ArrayDataset,
        device, test_ds: Optional[ArrayDataset] = None, output_dir: str = "",
        logger=None, device_data: Optional[Dict] = None,
        eval_device_data: Optional[Dict] = None,
        batch_hook: Optional[Callable] = None,
        patience: Optional[int] = None,
        label_smoothing: Optional[float] = None,
        inputs: Inputs = model_inputs, mesh=None,
        multi_step: Optional[Callable] = None, fused_steps: int = 1) -> Dict:
    """Run the training loop; returns {best_f1, best_epoch, history,
    test_metrics}. ``eval_device_data``: {"val": cols, "test": cols}.
    ``batch_hook(batch, epoch, it)`` rewrites each host train batch before
    it goes to the device (mixup); ``patience`` overrides
    TRAIN.EARLY_STOP_PATIENCE and ``label_smoothing``
    MODEL.LABEL_SMOOTHING; ``inputs`` maps a device batch onto the model's
    inputs (``core/train_state.py``); ``mesh``: data parallelism over its
    dp ranks; ``multi_step`` with ``fused_steps`` > 1: K steps per call
    (module docstring)."""
    if device_data is not None and batch_hook is not None:
        raise ValueError("device_data mode ships index batches; batch_hook "
                         "(host-side augmentation) cannot apply — disable "
                         "one of them")
    from mvuld_tpu_torch.parallel.mesh import (shard_batch, shard_superbatch,
                                               step_generator)
    # only the primary rank writes; every rank resumes from output_dir
    write_dir = output_dir if mesh is None or mesh.is_primary else ""
    logger = logger or create_logger(write_dir)
    if write_dir:
        # the resolved config beside the checkpoints: the predict CLI
        # rebuilds the run's model from it
        from mvuld_tpu_torch.config import save_config
        save_config(cfg, output_dir)
    batch_size = cfg.DATA.BATCH_SIZE
    stopper = EarlyStopper(patience=patience or cfg.TRAIN.EARLY_STOP_PATIENCE)
    if label_smoothing is None:
        label_smoothing = cfg.MODEL.LABEL_SMOOTHING
    best_save_full = cfg.TRAIN.BEST_SAVE != "params"
    best_fetch_async = cfg.TRAIN.BEST_FETCH == "async"
    gen = step_generator(mesh, device, cfg.SEED)
    best, history = None, []
    pending = None              # an async snapshot: (tree, epoch, f1)

    def write_best(tree, epoch, f1):
        if write_dir:
            save_checkpoint(write_dir, epoch,
                            {**tree, "epoch": epoch, "best_f1": f1},
                            best=True)

    start_epoch = cfg.TRAIN.START_EPOCH
    resume_path = (resume_ladder(output_dir, cfg.MODEL.RESUME,
                                 cfg.TRAIN.BEST_RESUME, cfg.TRAIN.AUTO_RESUME)
                   if output_dir else None)
    if resume_path:
        meta = restore(resume_path, model, opt)
        if meta["epoch"] >= 0:
            start_epoch = max(start_epoch, meta["epoch"] + 1)
        if meta["best_f1"] > float("-inf"):
            stopper.best, stopper.best_epoch = meta["best_f1"], meta["epoch"]
        logger.info(f"resumed from {resume_path}: epoch {meta['epoch']}, "
                    f"best_f1 {meta['best_f1']:.4f}")

    use_fused = multi_step is not None and fused_steps > 1

    def host_stream(epoch: int):
        """(is a superbatch, this rank's host batch, first it, samples):
        runs in the Prefetcher's thread."""
        def shard(b, superbatch=False):
            if mesh is None:
                return b
            return (shard_superbatch if superbatch else shard_batch)(mesh, b)

        pending_batches, it = [], -1
        for raw in train_batches(train_ds, batch_size, epoch, cfg.SEED):
            it += 1
            batch = batch_hook(raw, epoch, it) if batch_hook else raw
            if not use_fused:
                yield False, shard(batch), it, batch_size
                continue
            pending_batches.append(batch)
            if len(pending_batches) < fused_steps:
                continue
            sb = {k: np.stack([b[k] for b in pending_batches])
                  for k in pending_batches[0]}
            pending_batches = []
            yield (True, shard(sb, True), it - fused_steps + 1,
                   fused_steps * batch_size)
        for batch in pending_batches:     # the epoch's remainder
            yield False, shard(batch), it, batch_size

    def place(item):
        """The Prefetcher's last host step: the batch page-locked."""
        if torch.device(device).type != "cuda":
            return item
        return (item[0], pin_batch(item[1])) + item[2:]

    eval_dd = eval_device_data or {}
    for epoch in range(start_epoch, cfg.TRAIN.EPOCHS):
        t_epoch = time.time()
        loss_meter, speed_meter = AverageMeter(), WindowRate()
        for is_multi, b, it, n_done in Prefetcher(host_stream(epoch),
                                                  place, depth=2):
            if is_multi:
                metrics = (multi_step({"idx": b["idx"]}, gen, device_data)
                           if device_data is not None
                           else multi_step(b, gen))
                step_loss = metrics["loss"][-1]
            else:
                metrics = train_step(model, opt,
                                     to_device(b, device, device_data), gen,
                                     label_smoothing, inputs, mesh=mesh)
                step_loss = metrics["loss"]
            speed_meter.add(n_done)
            if it % cfg.PRINT_FREQ < (fused_steps if use_fused else 1):
                loss = float(step_loss)           # syncs — only on print
                loss_meter.update(loss, n_done)
                logger.info(f"epoch {epoch} it {it}: loss {loss:.4f} "
                            f"({speed_meter.read():.1f} samples/s)")

        val_metrics = run_eval(model, val_ds, batch_size, device,
                               eval_dd.get("val"), inputs, mesh)
        history.append({"epoch": epoch, **val_metrics})
        logger.info(f"epoch {epoch} VAL  {format_metrics(val_metrics)} "
                    f"({time.time() - t_epoch:.1f}s)")

        if stopper.update(val_metrics["f1"], epoch):
            if best_fetch_async:
                if pending is not None:
                    best = _finish(pending[0])
                    write_best(best, *pending[1:])
                pending = (_snapshot(model, opt, best_save_full, True),
                           epoch, val_metrics["f1"])
            else:
                best = _finish(_snapshot(model, opt, best_save_full))
                write_best(best, epoch, val_metrics["f1"])
        if write_dir and cfg.SAVE_FREQ > 0 and (
                epoch % cfg.SAVE_FREQ == 0 or epoch == cfg.TRAIN.EPOCHS - 1):
            save_checkpoint(write_dir, epoch,
                            {**_finish(_snapshot(model, opt, True)),
                             "epoch": epoch, "best_f1": stopper.best})
        if stopper.should_stop:
            logger.info(f"early stop at epoch {epoch} "
                        f"(best f1 {stopper.best:.4f} @ {stopper.best_epoch})")
            break

    if pending is not None:         # the last async snapshot
        best = _finish(pending[0])
        write_best(best, *pending[1:])
    if best is not None:            # the best state for the test eval
        model.load_state_dict(best["params"])
    out = {"best_f1": stopper.best, "best_epoch": stopper.best_epoch,
           "history": history}
    if test_ds is not None:
        test_metrics = run_eval(model, test_ds, batch_size, device,
                                eval_dd.get("test"), inputs, mesh)
        logger.info(f"TEST {format_metrics(test_metrics)}")
        out["test_metrics"] = test_metrics
    if write_dir:
        os.makedirs(write_dir, exist_ok=True)
        with open(os.path.join(write_dir, "history.json"), "w") as f:
            json.dump({"history": history, "best_f1": stopper.best,
                       "best_epoch": stopper.best_epoch,
                       "test_metrics": out.get("test_metrics")}, f, indent=1)
    return out
