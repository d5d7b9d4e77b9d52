"""EAST detector training — the OCR pipeline's trainer, on the GPU.

Counterpart of ``mvuld_tpu/train/train_east.py`` (reference OCR/train.py:
Adam 1e-3, the learning rate ×0.1 at half the steps) with the reference's
active augmentation: per-step text-region-aware random crops
(OCR/dataset.py crop_img:197-248) plus ColorJitter(0.5, 0.5, 0.5); the gt
score/geo maps are rasterized after the crop (``ocr/gt.rasterize_gt``, numpy).

Training data comes from the renderer: every rendered CPG PNG ships exact
node-label boxes, cached as ``{out-dir}/corpus/east_canvas_{n}_{size}_{tag}
_s{seed}.npz`` (images [n, S, S, 3] uint8, quads, quad counts). Rendering
needs PIL (and pandas for the synthetic corpus); a step does not: with the
cache in place, ``--no-crop`` and a canvas of the model's input size, the
trainer needs neither PIL nor cv2, as on the GPU machine. The crop and
resize branches and the evaluations import PIL.

The step is optax.adam's (no clipping, no weight decay) through
``core/optim.Optimizer``; BatchNorm's running statistics update in the
train step (flax's momentum 0.99) and the evaluations use them. The
checkpoint (``{out-dir}/checkpoints/ckpt_epoch_{epochs}``) is what
``ocr/detect.load_east_detector`` and ``predict``/``pipeline --east-ckpt``
load.

Usage:
  python -m mvuld_tpu_torch.train.train_east --synthetic N [--img-size 256]
      [--epochs 20] [--no-crop] [--eval-synthetic M --eval-style heldout]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List, Tuple

import numpy as np

MAX_QUADS = 64          # per-image quad padding in the canvas cache


def corpus_path(cache: str, n_funcs: int, canvas_size: int, seed: int,
                tag: str = "default") -> str:
    """The canvas cache file ``build_east_corpus`` reads and writes. The
    seed is part of the key: the eval corpus (seed + 10000) never aliases
    the training corpus even when n, size and tag coincide."""
    return os.path.join(
        cache, f"east_canvas_{n_funcs}_{canvas_size}_{tag}_s{seed}.npz")


def build_east_corpus(n_funcs: int, canvas_size: int, seed: int, cache: str,
                      logger=None, style=None, tag: str = "default"
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Synthetic CPGs rendered to fixed canvases, without gt maps.

    Returns (images [n, S, S, 3] uint8, quads [n, MAX_QUADS, 4, 2] px,
    nquads [n], paths). Reads the cache without PIL when it exists."""
    npz = corpus_path(cache, n_funcs, canvas_size, seed, tag)
    if os.path.exists(npz):
        with np.load(npz) as z:
            return z["images"], z["quads"], z["nquads"], []

    from PIL import Image

    from mvuld_tpu_torch.tools.cpg import extract_line_cpg
    from mvuld_tpu_torch.tools.render import DEFAULT_STYLE, layout, render_cpg
    from mvuld_tpu_torch.tools.synthetic import generate_dataset

    randomize = style == "random"
    style = DEFAULT_STYLE if randomize else (style or DEFAULT_STYLE)
    os.makedirs(cache, exist_ok=True)
    df = generate_dataset(n_funcs, seed=seed)
    style_rng = np.random.RandomState(seed ^ 0x5EED)
    images, quads_all, nquads, paths = [], [], [], []
    for _, row in df.iterrows():
        cpg = extract_line_cpg(row.func_before)
        if cpg is None:
            continue
        g = cpg.filtered("all")
        if len(g.nodes) < 2:
            continue
        if randomize:
            # per-image domain randomization (geometry/shape/size only; the
            # held-out font face is never sampled — render.random_style)
            from mvuld_tpu_torch.tools.render import random_style
            style = random_style(style_rng)
        img_path = os.path.join(cache, f"{tag}_{int(row._id)}.png")
        img, _pos = render_cpg(g, out_path=img_path, style=style)
        boxes_px = layout(g, style)
        W, H = img.size
        sx, sy = canvas_size / W, canvas_size / H
        q = np.zeros((MAX_QUADS, 4, 2), np.float32)
        if len(boxes_px) > MAX_QUADS:
            # a truncated gt would supervise the dropped text as background;
            # skip oversized functions instead
            if logger:
                logger.info(f"skipping {tag}_{int(row._id)}: "
                            f"{len(boxes_px)} text boxes > MAX_QUADS="
                            f"{MAX_QUADS}")
            continue
        n_q = min(len(boxes_px), MAX_QUADS)
        for k, (x0, y0, x1, y1) in enumerate(list(boxes_px.values())[:MAX_QUADS]):
            q[k] = [[x0 * sx, y0 * sy], [x1 * sx, y0 * sy],
                    [x1 * sx, y1 * sy], [x0 * sx, y1 * sy]]
        img_r = img.resize((canvas_size, canvas_size), Image.BILINEAR)
        images.append(np.asarray(img_r, np.uint8))
        quads_all.append(q)
        nquads.append(n_q)
        paths.append(img_path)
    arrs = (np.stack(images), np.stack(quads_all),
            np.asarray(nquads, np.int32))
    np.savez_compressed(npz, images=arrs[0], quads=arrs[1], nquads=arrs[2])
    if logger:
        logger.info(f"built EAST canvas corpus ({tag}): "
                    f"{arrs[0].shape[0]} images of {canvas_size}²")
    return (*arrs, paths)


def synthetic_canvases(n: int, size: int, seed: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A corpus in the cache's layout without the renderer: white canvases
    with 1-6 text-like boxes each (light grey, with dark stripes for the
    text lines), their quads and counts; numpy only, from
    ``seed``. ``np.savez`` them to ``corpus_path(...)`` and the trainer
    reads them as a rendered corpus."""
    rng = np.random.RandomState(seed)
    images = np.full((n, size, size, 3), 255, np.uint8)
    quads = np.zeros((n, MAX_QUADS, 4, 2), np.float32)
    nquads = np.zeros(n, np.int32)
    for i in range(n):
        taken = np.zeros((size, size), bool)
        for _ in range(rng.randint(2, 7)):
            w = int(rng.randint(size // 5, size // 2))
            h = int(rng.randint(max(size // 24, 3), max(size // 10, 5)))
            x0 = int(rng.randint(2, size - w - 2))
            y0 = int(rng.randint(2, size - h - 2))
            if taken[y0 - 2:y0 + h + 2, x0 - 2:x0 + w + 2].any():
                continue
            taken[y0:y0 + h, x0:x0 + w] = True
            images[i, y0:y0 + h, x0:x0 + w] = 200
            for r in range(y0 + 1, y0 + h - 1, 2):
                images[i, r, x0 + 1:x0 + w - 1] = rng.randint(0, 80)
            quads[i, nquads[i]] = [[x0, y0], [x0 + w, y0], [x0 + w, y0 + h],
                                   [x0, y0 + h]]
            nquads[i] += 1
    return images, quads, nquads


def _normalize(img_np: np.ndarray) -> np.ndarray:
    """uint8 → the reference's Normalize(mean=.5, std=.5) float input."""
    return (img_np.astype(np.float32) / 255.0 - 0.5) / 0.5


def make_batch(images: np.ndarray, quads: np.ndarray, nquads: np.ndarray,
               idx: np.ndarray, img_size: int, rng: np.random.RandomState,
               crop: bool = True) -> dict:
    """Host-side batch assembly: crop (or plain resize), jitter, rasterize;
    channel-last numpy arrays, as in the JAX version. PIL only for the crop
    and resize branches."""
    from mvuld_tpu_torch.ocr.gt import rasterize_gt

    xs, ss, gs, igs = [], [], [], []
    for i in idx:
        img = images[i]
        q = quads[i, : nquads[i]]
        if crop:
            from PIL import Image

            from mvuld_tpu_torch.data.transforms import color_jitter
            from mvuld_tpu_torch.ocr.gt import crop_with_text
            pil, q = crop_with_text(Image.fromarray(img), q, img_size, rng)
            img = np.asarray(color_jitter(pil, rng, strength=0.5))
        elif img.shape[:2] != (img_size, img_size):
            from PIL import Image
            sx = img_size / img.shape[1]
            sy = img_size / img.shape[0]
            img = np.asarray(Image.fromarray(img).resize(
                (img_size, img_size), Image.BILINEAR))
            q = q.copy()
            q[..., 0] *= sx
            q[..., 1] *= sy
        score, geo, ign = rasterize_gt(list(q), img_size, img_size)
        xs.append(_normalize(img))
        ss.append(score)
        gs.append(geo)
        igs.append(ign)
    return {"image": np.stack(xs), "score": np.stack(ss),
            "geo": np.stack(gs), "ignored": np.stack(igs)}


def lr_schedule(lr: float, steps: int) -> Callable[[int], float]:
    """optax.piecewise_constant_schedule(lr, {steps // 2: 0.1}): ×0.1 from
    step ``steps // 2`` on, in float32 as optax computes it."""
    base = np.float32(lr)
    low = float(base * np.float32(0.1))
    boundary = steps // 2

    def schedule(count: int) -> float:
        return low if count >= boundary else float(base)

    schedule.total_steps = boundary        # constant from there (schedule.py)
    return schedule


def build_optimizer(model, lr: float, steps: int):
    """optax.adam(lr_schedule(lr, steps)): Adam, no clipping, no decay."""
    from mvuld_tpu_torch.core.optim import Optimizer

    params = list(model.named_parameters())
    return Optimizer(params, {n: False for n, _ in params},
                     lr_schedule(lr, steps), name="adamw", clip=None)


def train_step(model, opt, batch: dict, device) -> float:
    """One step on a ``make_batch`` batch: forward in train mode (BatchNorm
    statistics updated), ``east_loss``, backward, Adam. Returns the loss."""
    import torch

    from mvuld_tpu_torch.ocr.east import east_loss, to_nchw

    b = {k: to_nchw(v).to(device) for k, v in batch.items()}
    score, geo = model(b["image"], train=True)
    loss = east_loss(b["score"], score, b["geo"], geo, b["ignored"])
    grads = torch.autograd.grad(loss, opt.params)
    opt.update(grads)
    return loss.detach()


def _eval_apply(model):
    from mvuld_tpu_torch.ocr.detect import east_apply_fn
    return east_apply_fn(next(model.parameters()).device)


def evaluate_hmean(model, images, quads, nquads, img_size: int,
                   batch_size: int = 8) -> dict:
    """ICDAR IoU-0.5 H-mean of the detector (eval mode, running statistics)
    on a canvas corpus resized to the model input size (quads scaled
    along)."""
    from mvuld_tpu_torch.ocr.detect import get_boxes
    from mvuld_tpu_torch.ocr.icdar_eval import (evaluate_dataset,
                                                evaluate_detections)

    apply_fn = _eval_apply(model)
    per_image = []
    n = images.shape[0]
    for lo in range(0, n, batch_size):
        idx = np.arange(lo, min(lo + batch_size, n))
        xs, gts = [], []
        for i in idx:
            img = images[i]
            sx, sy = img_size / img.shape[1], img_size / img.shape[0]
            q = quads[i, : nquads[i]].copy()
            q[..., 0] *= sx
            q[..., 1] *= sy
            if img.shape[:2] != (img_size, img_size):
                from PIL import Image
                img = np.asarray(Image.fromarray(img).resize(
                    (img_size, img_size), Image.BILINEAR))
            xs.append(_normalize(img))
            gts.append(q)
        score, geo = apply_fn(model, np.stack(xs))
        for k in range(len(idx)):
            boxes = get_boxes(score[k], geo[k])
            det = ([] if boxes is None
                   else [b[:8].reshape(4, 2) for b in boxes])
            per_image.append(evaluate_detections(
                list(gts[k]), [False] * len(gts[k]), det))
    return evaluate_dataset(per_image)


def evaluate_recovery(model, n_funcs: int, seed: int, style, cache: str,
                      logger=None) -> dict:
    """End-to-end line-number recovery on the original rendered PNGs:
    detect → crop → read the line number (reference OCR/detect.py:285-353).
    A gt node counts as recovered iff its line number is read and the
    recovered box's centre falls inside the gt box. Needs PIL."""
    from mvuld_tpu_torch.ocr.detect import detect_image
    from mvuld_tpu_torch.ocr.recognize import LinenoReader
    from mvuld_tpu_torch.tools.cpg import extract_line_cpg
    from mvuld_tpu_torch.tools.render import layout, render_cpg
    from mvuld_tpu_torch.tools.synthetic import generate_dataset

    apply_fn = _eval_apply(model)
    reader = LinenoReader()
    df = generate_dataset(n_funcs, seed=seed)
    total_gt = recovered = wrong_lineno = extra = 0
    n_imgs = 0
    os.makedirs(cache, exist_ok=True)
    for _, row in df.iterrows():
        cpg = extract_line_cpg(row.func_before)
        if cpg is None:
            continue
        g = cpg.filtered("all")
        if len(g.nodes) < 2 or len(g.nodes) > MAX_QUADS:
            continue
        img, _ = render_cpg(g, out_path=None, style=style)
        gt_boxes = layout(g, style)               # {lineno: (x0,y0,x1,y1)}
        n_imgs += 1
        total_gt += len(gt_boxes)
        boxes = detect_image(apply_fn, model, img, pad_to=256)
        pos = {}
        if boxes is not None:
            W, H = img.size
            for b in boxes:
                xs, ys = b[0:8:2], b[1:8:2]
                x0, x1 = float(xs.min()), float(xs.max())
                y0, y1 = float(ys.min()), float(ys.max())
                pad = 2
                crop = img.crop((max(x0 - pad, 0), max(y0 - pad, 0),
                                 min(x1 + pad, W), min(y1 + pad, H)))
                lineno = reader.read(crop)
                if lineno is not None:
                    pos[lineno] = (x0, y0, x1, y1)
        for lineno, (gx0, gy0, gx1, gy1) in gt_boxes.items():
            if lineno not in pos:
                continue
            x0, y0, x1, y1 = pos[lineno]
            cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
            if gx0 <= cx <= gx1 and gy0 <= cy <= gy1:
                recovered += 1
            else:
                wrong_lineno += 1
        extra += sum(1 for ln in pos if ln not in gt_boxes)
    out = {
        "images": n_imgs, "gt_nodes": total_gt,
        "recovered": recovered,
        "recovery_rate": round(recovered / max(total_gt, 1), 4),
        "misplaced": wrong_lineno, "spurious_linenos": extra,
    }
    if logger:
        logger.info(f"lineno recovery: {out}")
    return out


def _run_evals(args, model, logger, result) -> dict:
    """Held-out-style H-mean and line-number recovery (shared by the
    training path and --eval-only)."""
    crop = not args.no_crop
    canvas = int(args.img_size * args.canvas_scale) if crop else args.img_size
    if args.eval_synthetic or args.eval_recovery:
        from mvuld_tpu_torch.tools.render import DEFAULT_STYLE, HELD_OUT_STYLE
        style = (HELD_OUT_STYLE if args.eval_style == "heldout"
                 else DEFAULT_STYLE)
    if args.eval_synthetic:
        ev_imgs, ev_quads, ev_nq, _ = build_east_corpus(
            args.eval_synthetic, canvas, args.seed + 10_000,
            os.path.join(args.out_dir, "corpus"), logger, style=style,
            tag=args.eval_style)
        metrics = evaluate_hmean(model, ev_imgs, ev_quads, ev_nq,
                                 args.img_size)
        logger.info(f"detection eval ({args.eval_style} style): {metrics}")
        result["eval"] = metrics
    if args.eval_recovery:
        result["recovery"] = evaluate_recovery(
            model, args.eval_recovery, args.seed + 20_000, style,
            os.path.join(args.out_dir, "corpus"), logger)
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--synthetic", type=int, default=100)
    parser.add_argument("--img-size", type=int, default=256)
    parser.add_argument("--canvas-scale", type=float, default=1.5,
                        help="canvas side = scale · img-size (crop source)")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--train-style", choices=["default", "random"],
                        default="default",
                        help="'random' = per-image domain randomization "
                             "(geometry/shape/font-size jitter; the "
                             "held-out font face is never sampled)")
    parser.add_argument("--no-crop", action="store_true",
                        help="disable the reference crop augmentation")
    parser.add_argument("--eval-synthetic", type=int, default=0,
                        help="render M extra functions for detection eval")
    parser.add_argument("--eval-style", choices=["default", "heldout"],
                        default="default")
    parser.add_argument("--eval-recovery", type=int, default=0,
                        help="run detect→recognize line-number recovery on N "
                             "natively-rendered eval functions")
    parser.add_argument("--out-dir", default="runs/east")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval-only", default=None, metavar="CKPT_DIR",
                        help="skip training; load the newest ckpt_epoch_* "
                             "under CKPT_DIR and run the requested evals")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mvuld_tpu_torch.core.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from mvuld_tpu_torch.core.logger import create_logger
    from mvuld_tpu_torch.models import convert
    from mvuld_tpu_torch.ocr.east import EAST
    from mvuld_tpu_torch.train.predict import resolve_device

    logger = create_logger(args.out_dir)
    device = resolve_device(args.device)
    crop = not args.no_crop
    canvas = int(args.img_size * args.canvas_scale) if crop else args.img_size
    images, quads, nquads, _ = build_east_corpus(
        args.synthetic, canvas, args.seed,
        os.path.join(args.out_dir, "corpus"), logger,
        style="random" if args.train_style == "random" else None,
        tag=args.train_style)
    n = images.shape[0]
    logger.info(f"EAST corpus: {n} canvases of {canvas}², "
                f"crop={'on' if crop else 'off'} → {args.img_size}²")

    model = EAST()
    convert.init_jax_like(model, torch.Generator().manual_seed(args.seed))
    if args.eval_only:
        from mvuld_tpu_torch.ocr.detect import resolve_east_checkpoint
        model.load_state_dict(load_checkpoint(
            resolve_east_checkpoint(args.eval_only))["params"])
        model.to(device).eval()
        return _run_evals(args, model, logger, {"losses": [], "model": model})
    model.to(device)

    # Adam + step decay at half the steps (reference: OCR/train.py:25-33)
    steps_per_epoch = max(n // args.batch_size, 1)
    opt = build_optimizer(model, args.lr, steps_per_epoch * args.epochs)

    rng_np = np.random.RandomState(args.seed)
    step_losses = []
    for epoch in range(args.epochs):
        order = rng_np.permutation(n)
        epoch_loss = []
        for b in range(steps_per_epoch):
            idx = order[b * args.batch_size:(b + 1) * args.batch_size]
            if len(idx) == 0:
                continue
            host = make_batch(images, quads, nquads, idx, args.img_size,
                              rng_np, crop=crop)
            epoch_loss.append(train_step(model, opt, host, device))
        step_losses.append(float(torch.stack(epoch_loss).mean().cpu())
                           if epoch_loss else float("nan"))
        logger.info(f"epoch {epoch}: loss {step_losses[-1]:.4f}")

    model.eval()
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    stats = {k: v for k, v in state.items() if k.endswith(("running_mean",
                                                           "running_var"))}
    save_checkpoint(args.out_dir, args.epochs,
                    {"params": state, "batch_stats": stats,
                     "epoch": args.epochs})
    result = {"params": dict(model.named_parameters()), "batch_stats": stats,
              "losses": step_losses, "model": model}
    return _run_evals(args, model, logger, result)


if __name__ == "__main__":
    main()
