"""Full MVulD pipeline, one command from corpus to fused test
metrics (counterpart of ``mvuld_tpu/train/pipeline.py``).

Chains the reference's multi-stage recipe (process_dataset → getImages →
cunixcoder embeddings → main_bigvul) into one entry point with idempotent
stages:

  1. prepare   — clean/split/rebalance the corpus (or generate synthetic),
  2. text      — fine-tune the UniXcoder classifier; keep encoder + tokenizer,
  3. image     — fine-tune SwinV2 on the rendered graphs (--swin-epochs N) or
                 load a trained checkpoint (--swin-ckpt: a ``train_swin``
                 output directory, its best-F1 checkpoint picked, or a
                 checkpoint file of the port; a reference .pth seeds the
                 fine-tune as --pretrained); the frozen
                 trained encoder then produces img_emb. Without either flag
                 a random projection stands in (tests without checkpoints),
  4. render    — CPGs → PNGs + oracle node positions, or with --east-ckpt
                 EAST detection + line-number recognition (``ocr/``),
  5. cache     — npz feature caches from the trained text + image encoders,
  6. fuse      — train the fusion architecture; report test metrics.

The frozen featurizers are the port's modules in eval mode under
``torch.no_grad()`` on the device; so is the EAST detector of
``--east-ckpt``, whose line-number reader needs PIL.

Usage:
  python -m mvuld_tpu_torch.train.pipeline --synthetic 400 --out runs/pipeline \\
      [--arch multi_defect_new_gcn] [--swin-epochs 3 | --swin-ckpt runs/swin] \\
      [--data corpus.pkl] [--device cuda|cpu] [--opts ...]
"""

from __future__ import annotations

import argparse
import json
import os


def _swin_checkpoint(path: str) -> str:
    """A checkpoint file from ``path``: the file itself, the newest
    best-F1 checkpoint under a ``train_swin`` output root, or else the
    newest epoch checkpoint of ``path`` (``tools/convert_checkpoint``'s
    output directory)."""
    from mvuld_tpu_torch.core.checkpoint import (auto_resume_helper,
                                                 resume_bestf1_helper)

    if not os.path.isdir(path):
        return path
    import glob
    cands = sorted(glob.glob(os.path.join(path, "**", "checkpoint-best-f1"),
                             recursive=True))
    found = (resume_bestf1_helper(os.path.dirname(cands[-1])) if cands
             else auto_resume_helper(path))
    if not found:
        raise FileNotFoundError(f"no checkpoint-best-f1 or epoch checkpoint "
                                f"under {path}")
    return found


def _ocr_positions(east_ckpt: str, df, cache_dir: str, out_dir: str, cfg,
                   logger, device) -> dict:
    """Node positions the reference's production way: EAST detection (on
    ``device``) + line-number recognition (PIL) over the rendered PNGs
    (OCR/detect.py detect_dataset_map:285-353), written as norm-pos pickles
    to ``out_dir``. Returns recovery stats against the renderer's oracle
    boxes."""
    from mvuld_tpu_torch.ocr.detect import (detect_dataset_map,
                                            load_east_detector)
    from mvuld_tpu_torch.tools.render import load_norm_pos
    from mvuld_tpu_torch.train.precompute import render_corpus

    img_dir = os.path.join(cache_dir, "imgs")
    oracle_dir = os.path.join(cache_dir, "pos")
    paths = render_corpus(df, img_dir, oracle_dir, cfg.DATA.GTYPE, logger)

    apply_fn, east_params = load_east_detector(east_ckpt, device)
    detect_dataset_map(apply_fn, east_params,
                       [paths[_id] for _id in sorted(paths)], out_dir,
                       pad_to=256, logger=None)

    total = recovered = 0
    for _id in paths:
        oracle = load_norm_pos(os.path.join(oracle_dir, f"{_id}.pkl"))
        ocr = load_norm_pos(os.path.join(out_dir, f"{_id}.pkl"))
        total += len(oracle)
        recovered += sum(1 for lineno in oracle if lineno in ocr)
    stats = {"ocr_node_recovery": recovered / max(total, 1),
             "ocr_images": len(paths), "ocr_oracle_nodes": total}
    if logger:
        logger.info(f"OCR positions: {stats}")
    return stats


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--hard", action="store_true",
                        help="value-binding synthetic corpus "
                             "(tools/synthetic.py hard mode)")
    parser.add_argument("--data", default=None)
    parser.add_argument("--out", required=True)
    parser.add_argument("--arch", default="multi_defect_new_gcn")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--text-epochs", type=int, default=6)
    parser.add_argument("--swin-epochs", type=int, default=0,
                        help="fine-tune SwinV2 on the rendered graphs for N "
                             "epochs before caching image features")
    parser.add_argument("--swin-ckpt", default=None,
                        help="trained SwinV2: a train_swin output dir "
                             "(best-F1 picked), a checkpoint file of it, or "
                             "a reference .pth (used as --pretrained when "
                             "fine-tuning)")
    parser.add_argument("--fusion-epochs", type=int, default=8)
    parser.add_argument("--east-ckpt", default=None,
                        help="trained EAST detector (train_east --out-dir "
                             "root, a checkpoint of it, or a JAX run's "
                             "variables as .npz): node positions then come "
                             "from EAST detection + line-number "
                             "recognition over the rendered PNGs — the "
                             "reference's production OCR path — instead of "
                             "the renderer's oracle boxes")
    parser.add_argument("--opts", nargs="+", default=None)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    args = parser.parse_args(argv)

    import gc

    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.logger import create_logger
    from mvuld_tpu_torch.models.unixcoder import UniXcoderEmbedder
    from mvuld_tpu_torch.train.precompute import (build_fusion_cache,
                                                  frozen_swin_encoder,
                                                  frozen_text_encoder,
                                                  make_random_encoders)
    from mvuld_tpu_torch.train.predict import resolve_device
    from mvuld_tpu_torch.train.train_fusion import main as fusion_main
    from mvuld_tpu_torch.train.train_text import main as text_main

    logger = create_logger(args.out)
    os.makedirs(args.out, exist_ok=True)
    device = resolve_device(args.device)
    common_opts = list(args.opts or [])
    corpus = (["--synthetic", str(args.synthetic)]
              + (["--hard"] if args.hard else []) if args.synthetic
              else ["--data", args.data])

    # ---- stages 1-2: corpus + text encoder
    text_res = text_main([*corpus, "--batch-size", str(args.batch_size),
                          "--output", os.path.join(args.out, "text"),
                          "--device", args.device, "--opts", *common_opts,
                          "TRAIN.EPOCHS", str(args.text_epochs)])
    tok = text_res["tokenizer"]
    rcfg = text_res["roberta_config"]
    text_best_f1 = text_res["best_f1"]
    text_test = text_res.get("test_metrics")
    logger.info(f"text stage done: best_f1={text_best_f1:.4f}")
    # keep the trained encoder on the host and release the text stage's
    # device state (model + AdamW moments) before the swin stage needs the
    # memory; the featurizer moves back to the device when the cache is built
    embedder = UniXcoderEmbedder(rcfg)
    embedder.encoder.load_state_dict(
        {k: v.cpu() for k, v in text_res["model"].encoder.state_dict().items()})
    del text_res
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- stages 3-4: render + caches (trained text, swin features)
    class _A:
        cfg = None
        opts = common_opts or None
        batch_size = args.batch_size

    cfg = get_config(_A())
    cfg.defrost()
    cfg.MODEL.MULTI.TEXT_DIM = rcfg.hidden_size
    cfg.freeze()

    if args.synthetic:
        from mvuld_tpu_torch.tools.dataset import prepare_corpus
        from mvuld_tpu_torch.tools.synthetic import generate_dataset
        df = prepare_corpus(generate_dataset(args.synthetic,
                                             seed=cfg.SEED or 42,
                                             hard=args.hard))
    else:
        import pandas as pd
        df = pd.read_pickle(args.data)

    cache_dir = os.path.join(args.out, "cache")

    # ---- stage: trained image encoder (fine-tune and/or load best-F1)
    swin_encoder = None
    swin_best_f1 = swin_test = None
    if args.swin_epochs > 0 or args.swin_ckpt:
        from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                    SwinV2Config)

        sc = SwinV2Config.from_cfg(cfg)
        if args.swin_epochs > 0:
            from mvuld_tpu_torch.train.train_swin import main as swin_main
            pretrained = (["--pretrained", args.swin_ckpt]
                          if args.swin_ckpt
                          and args.swin_ckpt.endswith((".pth", ".pt", ".bin"))
                          else [])
            swin_res = swin_main(
                [*corpus, "--batch-size", str(args.batch_size),
                 "--output", os.path.join(args.out, "swin"),
                 "--cache-dir", cache_dir, "--device", args.device,
                 *pretrained, "--opts", *common_opts,
                 "TRAIN.EPOCHS", str(args.swin_epochs)])
            swin_model = swin_res["model"]          # holds the best-F1 state
            swin_best_f1 = swin_res["best_f1"]
            swin_test = swin_res.get("test_metrics")
            logger.info(f"swin stage done: best_f1={swin_best_f1:.4f}")
            del swin_res
            gc.collect()
        else:
            from mvuld_tpu_torch.core.checkpoint import load_checkpoint
            path = _swin_checkpoint(args.swin_ckpt)
            swin_model = SwinTransformerV2(sc,
                                           num_classes=cfg.MODEL.NUM_CLASSES)
            swin_model.load_state_dict(load_checkpoint(path)["params"])
            logger.info(f"loaded trained swin encoder from {path}")
        # frozen forward_features featurizer (cache_swin_features)
        swin_encoder = frozen_swin_encoder(swin_model, device)
        cfg.defrost()
        cfg.MODEL.MULTI.IMG_DIM = sc.num_features
        cfg.freeze()

    if swin_encoder is None:
        _, swin_encoder = make_random_encoders(cfg)

    # ---- optional OCR stage: EAST-detected node positions instead of the
    # renderer oracle. The npz caches go to a separate dir (imgs/pos
    # symlinked, not re-rendered) so oracle- and OCR-positioned caches never
    # shadow each other.
    ocr_stats = None
    npz_dir, ocr_pos_dir = cache_dir, None
    if args.east_ckpt:
        ocr_pos_dir = os.path.join(cache_dir, "pos_ocr")
        ocr_stats = _ocr_positions(args.east_ckpt, df, cache_dir, ocr_pos_dir,
                                   cfg, logger, device)
        npz_dir = os.path.join(args.out, "cache_ocr")
        os.makedirs(npz_dir, exist_ok=True)
        for sub in ("imgs", "pos"):
            link = os.path.join(npz_dir, sub)
            if not os.path.exists(link):
                os.symlink(os.path.abspath(os.path.join(cache_dir, sub)),
                           link)
    build_fusion_cache(df, npz_dir, cfg,
                       text_encoder=frozen_text_encoder(embedder, device),
                       swin_encoder=swin_encoder, tokenizer=tok,
                       logger=logger, pos_dir=ocr_pos_dir)
    del embedder, swin_encoder
    gc.collect()

    # ---- stage 5: fusion
    fusion_res = fusion_main([
        "--cache-dir", npz_dir,
        "--batch-size", str(args.batch_size),
        "--output", os.path.join(args.out, "fusion"),
        "--arch", args.arch, "--device", args.device,
        "--opts", *common_opts,
        "MODEL.MULTI.TEXT_DIM", str(rcfg.hidden_size),
        "MODEL.MULTI.IMG_DIM", str(cfg.MODEL.MULTI.IMG_DIM),
        "TRAIN.EPOCHS", str(args.fusion_epochs),
    ])
    summary = {
        "text_best_f1": text_best_f1,
        "text_test": text_test,
        "fusion_best_f1": fusion_res["best_f1"],
        "fusion_test": fusion_res.get("test_metrics"),
        "arch": args.arch,
        "image_encoder": ("trained" if (args.swin_epochs > 0 or args.swin_ckpt)
                          else "random_projection"),
        "positions": "ocr" if args.east_ckpt else "oracle",
        "swin_best_f1": swin_best_f1,
        "swin_test": swin_test,
    }
    if ocr_stats:
        summary.update(ocr_stats)
    with open(os.path.join(args.out, "pipeline_summary.json"), "w") as f:
        json.dump(summary, f, indent=1, default=float)
    logger.info(f"pipeline summary: {summary}")
    return {**summary, "fusion_result": fusion_res}


if __name__ == "__main__":
    main()
