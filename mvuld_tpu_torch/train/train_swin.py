"""SwinV2 fine-tune on rendered code-graph images — the main.py equivalent
(counterpart of ``mvuld_tpu/train/train_swin.py``).

Replicates the reference's image-encoder fine-tune path (mvuld/main.py
:55-514): manifest datasets, timm-style train augmentation + mixup/cutmix
soft targets, CE with label smoothing, AdamW + cosine with the LR-scaling
rule, grad clip 5.0, best-F1 early stop (patience 10), optional
pretrained-checkpoint conversion (``models/swin_convert.py``), and the
``--throughput`` mode (50 warm-up and 30 timed forwards, main.py:438-455).

On a CUDA device the model runs the port's kernels: K1 attention with K2
(or, under ``MVULD_ATTN_BWD=v1``, K5) as its backward, and with
TRAIN.FUSED_MLP the K3/K3b MLP halves; on the CPU it runs the plain layers,
as the JAX trainer runs its XLA path off the TPU. ``build_swin_training``
makes the model, the optimizer and the step for ``main`` and for any other
caller that feeds its own image tensors. PARALLEL.DP / MP lay the ranks of
a torchrun launch out as the JAX mesh (``parallel/mesh.py``): every rank
mixes the same global batch and trains on its block of rows.
TRAIN.FUSED_STEPS K > 1 trains K steps per call
(``core/train_state.make_multi_train_step``, as the JAX trainer does): on
the card one CUDA graph replay per K steps, on the CPU a loop.

Usage:
  python -m mvuld_tpu_torch.train.train_swin --cfg cfg.yaml [--synthetic N]
      [--pretrained swinv2.pth] [--test] [--throughput] [--device cuda|cpu]
      [--opts ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np


def build_image_datasets(cfg, df, img_dir, pos_dir, logger):
    """Render graphs (idempotent) and build train/val/test image datasets."""
    from mvuld_tpu_torch.data.loader import ArrayDataset
    from mvuld_tpu_torch.data.transforms import (load_image, resize_normalize,
                                                 train_transform)
    from mvuld_tpu_torch.train.precompute import render_corpus

    paths = render_corpus(df, img_dir, pos_dir, cfg.DATA.GTYPE, logger)
    size = cfg.DATA.IMG_SIZE
    out = {}
    for part in ("train", "val", "test"):
        rows = df[(df.label == part) & df._id.isin(paths)]
        if not len(rows):
            continue
        img_paths = [paths[int(i)] for i in rows._id]
        labels = rows.vul.to_numpy().astype(np.int32)
        if part == "train":
            def tf(item, rng):
                img = load_image(item["path"])
                x = train_transform(img, size, rng,
                                    cfg.AUG.COLOR_JITTER, cfg.AUG.REPROB)
                return {"image": x, "label": item["label"]}
        else:
            def tf(item, rng):
                x = resize_normalize(load_image(item["path"]), size)
                return {"image": x, "label": item["label"]}
        out[part] = ArrayDataset({"path": img_paths, "label": labels},
                                 transform=tf)
    return out


@dataclasses.dataclass
class SwinTraining:
    """The fine-tune's model, optimizer and step. ``batch_hook`` turns a
    host batch {"image", "label"} into the step's (mixup/cutmix images and
    "soft_label"); ``step`` trains on a device batch."""

    model: object
    opt: object
    label_smoothing: float
    batch_hook: Callable[[Dict, int, int], Dict]
    mesh: object = None

    def step(self, batch, gen):
        from mvuld_tpu_torch.core.train_state import image_inputs, train_step
        return train_step(self.model, self.opt, batch, gen,
                          self.label_smoothing, image_inputs, mesh=self.mesh)

    def multi_step(self, num_steps: int, capture: Optional[bool] = None):
        """``num_steps`` steps per call on a [K, B, ...] superbatch
        (``capture=False``: eager steps on the card too)."""
        from mvuld_tpu_torch.core.train_state import (image_inputs,
                                                      make_multi_train_step)
        return make_multi_train_step(self.model, self.opt, num_steps,
                                     self.label_smoothing, image_inputs,
                                     mesh=self.mesh, capture=capture)


def build_swin_training(cfg, device, steps_per_epoch: int = 1,
                        pretrained: Optional[str] = None,
                        kernels: Optional[bool] = None,
                        mesh=None) -> SwinTraining:
    """SwinTransformerV2 with its head, initialised with the JAX
    initialisers from ``cfg.SEED`` or loaded from ``pretrained``; AdamW
    with the config's schedule; mixup soft targets from a generator seeded
    ``cfg.SEED + 1`` (label smoothing folded into them, else applied in the
    loss). ``kernels`` (by default on CUDA) runs the attention kernels and,
    with TRAIN.FUSED_MLP, the fused MLP; off, the plain layers.
    TRAIN.USE_CHECKPOINT with TRAIN.REMAT_STAGES (empty: every stage) picks
    the checkpointed stages. ``mesh``: the parameters broadcast from rank
    0 and the step data-parallel."""
    import torch

    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.schedule import build_schedule
    from mvuld_tpu_torch.data.transforms import mixup_cutmix
    from mvuld_tpu_torch.models import convert
    from mvuld_tpu_torch.models.swin_convert import load_pretrained_swinv2
    from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                SwinV2Config)

    sc = SwinV2Config.from_cfg(cfg)
    if kernels is None:
        kernels = device.type == "cuda"
    remat = ((tuple(cfg.TRAIN.REMAT_STAGES) or tuple(range(len(sc.depths))))
             if cfg.TRAIN.USE_CHECKPOINT else ())
    model = SwinTransformerV2(sc, use_pallas=kernels,
                              use_pallas_mlp=kernels and cfg.TRAIN.FUSED_MLP,
                              remat_stages=remat,
                              num_classes=cfg.MODEL.NUM_CLASSES)
    convert.init_jax_like(model, torch.Generator().manual_seed(cfg.SEED))
    if pretrained:
        load_pretrained_swinv2(model, pretrained)
    model.to(device)
    if mesh is not None:
        from mvuld_tpu_torch.parallel.mesh import replicate
        replicate(mesh, model)
    B = cfg.DATA.BATCH_SIZE
    opt = build_optimizer(cfg, build_schedule(cfg, steps_per_epoch, B), model)

    # batch-level mixup/cutmix producing soft targets (main.py:267-269)
    a = cfg.AUG
    mix_rng = np.random.RandomState(cfg.SEED + 1)
    use_mix = a.MIXUP > 0 or a.CUTMIX > 0

    def batch_hook(batch, epoch, it):
        if not use_mix:
            return batch
        images, soft = mixup_cutmix(
            batch["image"], batch["label"], cfg.MODEL.NUM_CLASSES, mix_rng,
            a.MIXUP, a.CUTMIX, a.MIXUP_PROB, a.MIXUP_SWITCH_PROB,
            cfg.MODEL.LABEL_SMOOTHING)
        return {**batch, "image": images, "soft_label": soft}

    # mixup folds LABEL_SMOOTHING into the soft targets; without mixup the
    # reference falls back to LabelSmoothingCrossEntropy (main.py:136-142)
    smoothing = 0.0 if use_mix else cfg.MODEL.LABEL_SMOOTHING
    return SwinTraining(model, opt, smoothing, batch_hook, mesh)


def throughput(model, cfg, device, warmup: int = 50, iters: int = 30
               ) -> float:
    """Images/s of the eval forward at DATA.BATCH_SIZE on seeded normal
    images (reference protocol: 50 warm-up and 30 timed iterations,
    main.py:438-455), the device synchronised before and after."""
    import torch

    B, size = cfg.DATA.BATCH_SIZE, cfg.DATA.IMG_SIZE
    x = torch.as_tensor(np.random.RandomState(0).randn(B, size, size, 3),
                        dtype=torch.float32, device=device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda *a: None))
    model.eval()
    with torch.inference_mode():
        for _ in range(warmup):
            model(x)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        sync(device)
    return iters * B / (time.perf_counter() - t0)


def corpus_datasets(args, cfg, mesh, logger) -> Dict:
    """The image datasets of ``--synthetic N`` or ``--data`` (a pickled
    corpus frame): the corpus rendered into the cache (``--cache-dir``,
    else OUTPUT/cache; the primary rank first) and split by its labels."""
    from mvuld_tpu_torch.parallel.mesh import primary_first

    if args.synthetic:
        from mvuld_tpu_torch.tools.dataset import prepare_corpus
        from mvuld_tpu_torch.tools.synthetic import generate_dataset
        df = prepare_corpus(generate_dataset(args.synthetic,
                                             seed=cfg.SEED or 42,
                                             hard=args.hard))
    else:
        import pandas as pd
        df = pd.read_pickle(args.data)
    cache_root = args.cache_dir or os.path.join(cfg.OUTPUT, "cache")
    with primary_first(mesh):
        return build_image_datasets(
            cfg, df, os.path.join(cache_root, "imgs"),
            os.path.join(cache_root, "pos"), logger)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--data", default=None)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--hard", action="store_true",
                        help="value-binding synthetic corpus "
                             "(tools/synthetic.py hard mode)")
    parser.add_argument("--batch-size", dest="batch_size", type=int)
    parser.add_argument("--pretrained", default=None)
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--throughput", action="store_true")
    parser.add_argument("--output", default=None)
    parser.add_argument("--cache-dir", dest="cache_dir", default=None,
                        help="shared image/pos cache dir (pipeline reuse); "
                             "defaults to OUTPUT/cache")
    parser.add_argument("--opts", nargs="+", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (the plain layers)")
    args = parser.parse_args(argv)

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.logger import create_logger
    from mvuld_tpu_torch.core.train_state import image_inputs
    from mvuld_tpu_torch.data.loader import steps_per_epoch
    from mvuld_tpu_torch.parallel.distributed import local_device
    from mvuld_tpu_torch.parallel.mesh import mesh_from_cfg
    from mvuld_tpu_torch.train.harness import fit, run_eval
    from mvuld_tpu_torch.train.predict import resolve_device

    cfg = get_config(args)
    device = resolve_device(args.device)
    mesh = mesh_from_cfg(cfg, device)
    device = local_device(device)
    logger = create_logger(cfg.OUTPUT if mesh.is_primary else "", mesh.rank)

    # ---- throughput mode (reference: main.py:438-455)
    if args.throughput or cfg.THROUGHPUT_MODE:
        run = build_swin_training(cfg, device, pretrained=args.pretrained)
        tp = throughput(run.model, cfg, device)
        logger.info(f"throughput: {tp:.1f} images/s "
                    f"(batch {cfg.DATA.BATCH_SIZE}, {device})")
        return {"throughput": tp}

    datasets = corpus_datasets(args, cfg, mesh, logger)
    logger.info(f"dataset sizes: { {k: len(v) for k, v in datasets.items()} }")

    spe = max(steps_per_epoch(len(datasets["train"]), cfg.DATA.BATCH_SIZE), 1)
    run = build_swin_training(cfg, device, spe, args.pretrained, mesh=mesh)
    if args.pretrained:
        logger.info(f"converted pretrained weights from {args.pretrained}")
    if args.test or cfg.EVAL_MODE:
        metrics = run_eval(run.model, datasets["test"], cfg.DATA.BATCH_SIZE,
                           device, inputs=image_inputs, mesh=mesh)
        logger.info(f"TEST(only) {metrics}")
        return {"test_metrics": metrics}
    k = cfg.TRAIN.FUSED_STEPS
    result = fit(cfg=cfg, model=run.model, opt=run.opt,
                 train_ds=datasets["train"],
                 val_ds=datasets.get("val", datasets["train"]), device=device,
                 test_ds=datasets.get("test"), output_dir=cfg.OUTPUT,
                 logger=logger, batch_hook=run.batch_hook, patience=10,
                 label_smoothing=run.label_smoothing, inputs=image_inputs,
                 mesh=mesh, multi_step=run.multi_step(k) if k > 1 else None,
                 fused_steps=k)
    result["model"] = run.model       # the best-F1 state, as ``fit`` left it
    return result


if __name__ == "__main__":
    main()
