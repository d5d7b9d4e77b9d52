"""Tri-modal fusion trainer — the main_bigvul.py equivalent (counterpart
of ``mvuld_tpu/train/train_fusion.py``).

Trains the fusion head (+GAT/Rs-GCN) over cached modality features (graph
arrays, SwinV2 img_emb, UniXcoder text/node embeddings, label): the
reference's staged regime with frozen encoders. Semantics preserved: CE with
label smoothing 0.1, AdamW with the scaled-LR rule, cosine schedule, clip
5.0, P(vul) > 0.5 decision, PR-AUC reporting, best-F1 checkpointing, patience
50, fp32 fusion compute (the reference disables AMP for fusion,
main_bigvul.py:328). The head is plain PyTorch on every device: the JAX
package has no kernel on this path either.

TRAIN.DEVICE_DATA / TRAIN.DEVICE_EVAL keep a split's columns on the device
and ship batches as row-index vectors gathered there (``harness.to_device``;
the JAX package's ``indexed=True`` steps); eval labels stay on the host for
the metric suite.

Usage:
  python -m mvuld_tpu_torch.train.train_fusion --cfg cfg.yaml \\
      --cache-dir caches/ [--synthetic N] [--arch multi_defect_new_gcn] \\
      [--test] [--device cuda|cpu] [--opts ...]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

FEATURE_COLUMNS = ("img_emb", "text_emb", "node_emb", "pos", "adj",
                   "node_mask", "ntype", "label")


def load_cached_datasets(cache_paths):
    from mvuld_tpu_torch.data.loader import ArrayDataset
    out = {}
    for part, path in cache_paths.items():
        z = np.load(path)
        # ids stay in the file: no step reads them
        cols = {k: z[k] for k in FEATURE_COLUMNS}
        # tokenized-node variant (reference item1 caches): older caches
        # lack the column
        if "token_ids" in z:
            cols["token_ids"] = z["token_ids"]
        out[part] = ArrayDataset(cols)
    return out


def edge_bits(gtype: str) -> int:
    """The bitmask of the edge types that graph type ``gtype`` keeps."""
    from mvuld_tpu_torch.tools.vocab import EDGE_TYPE_MAP, GRAPH_TYPE_EDGES
    bits = 0
    for t in sorted(GRAPH_TYPE_EDGES[gtype]):
        bits |= 1 << EDGE_TYPE_MAP[t]
    return bits


def fusion_inputs(bits: int):
    """Device batch → the fusion model's inputs, the uint8 adjacency
    bitmask filtered to ``bits`` on the device."""
    def inputs(batch: Dict) -> Dict:
        return {"img_emb": batch["img_emb"], "text_emb": batch["text_emb"],
                "node_emb": batch["node_emb"], "pos": batch["pos"],
                "adj": (batch["adj"] & bits) != 0,
                "node_mask": batch["node_mask"]}
    return inputs


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--cache-dir", default=None)
    parser.add_argument("--data", default=None, help="corpus pickle")
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--hard", action="store_true",
                        help="value-binding synthetic corpus "
                             "(tools/synthetic.py hard mode)")
    parser.add_argument("--arch", default=None)
    parser.add_argument("--batch-size", dest="batch_size", type=int)
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--output", default=None)
    parser.add_argument("--opts", nargs="+", default=None)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    args = parser.parse_args(argv)

    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.logger import create_logger
    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.schedule import build_schedule
    from mvuld_tpu_torch.data.loader import ArrayDataset, steps_per_epoch
    from mvuld_tpu_torch.models import convert
    from mvuld_tpu_torch.models.fusion_zoo import build_fusion_model
    from mvuld_tpu_torch.train.harness import fit, run_eval
    from mvuld_tpu_torch.train.precompute import (build_fusion_cache,
                                                  make_random_encoders)
    from mvuld_tpu_torch.train.predict import resolve_device

    cfg = get_config(args)
    output_dir = os.path.join(cfg.MULTI_OUTPUT, cfg.TAG) if not args.output \
        else cfg.OUTPUT
    logger = create_logger(output_dir)
    device = resolve_device(args.device)

    # ---- caches
    cache_dir = args.cache_dir or os.path.join(output_dir, "cache")
    parts = ("train", "val", "test")
    cache_paths = {p: os.path.join(cache_dir, f"{p}.npz") for p in parts}
    if not all(os.path.exists(p) for p in cache_paths.values()):
        if args.synthetic:
            from mvuld_tpu_torch.tools.dataset import prepare_corpus
            from mvuld_tpu_torch.tools.synthetic import generate_dataset
            df = prepare_corpus(generate_dataset(args.synthetic,
                                                 hard=args.hard,
                                                 seed=cfg.SEED or 42))
        else:
            if args.data is None:
                missing = [p for p in cache_paths.values()
                           if not os.path.exists(p)]
                raise FileNotFoundError(
                    f"fusion caches missing ({missing}) and no --data/"
                    f"--synthetic corpus given to rebuild them")
            import pandas as pd
            df = pd.read_pickle(args.data)
        from mvuld_tpu_torch.data.tokenizer import CodeTokenizer
        tok = CodeTokenizer.train(df.func_before.tolist(), vocab_size=2048)
        text_enc, swin_enc = make_random_encoders(cfg)
        cache_paths = build_fusion_cache(df, cache_dir, cfg,
                                         text_encoder=text_enc,
                                         swin_encoder=swin_enc,
                                         tokenizer=tok, logger=logger)
    datasets = load_cached_datasets(cache_paths)
    logger.info(f"dataset sizes: { {k: len(v) for k, v in datasets.items()} }")

    # ---- model (fp32) and optimizer
    arch = args.arch or cfg.MODEL.MULTI.ARCH
    model = build_fusion_model(cfg, arch=arch)
    logger.info(f"fusion arch: {arch}")
    convert.init_jax_like(model, torch.Generator().manual_seed(cfg.SEED))
    model.to(device)
    inputs = fusion_inputs(edge_bits(cfg.DATA.GTYPE))
    B = cfg.DATA.BATCH_SIZE
    spe = max(steps_per_epoch(len(datasets["train"]), B), 1)
    opt = build_optimizer(cfg, build_schedule(cfg, spe, B), model)

    def put_split(ds, drop=()):
        dd = {k: torch.as_tensor(np.asarray(v)).to(device)
              for k, v in ds.columns.items()
              if k not in drop
              and np.issubdtype(np.asarray(v).dtype, np.number)}
        return dd, sum(v.numel() * v.element_size() for v in dd.values())

    # TRAIN.DEVICE_DATA: the cached features go to the device once and
    # batches are int32 index vectors gathered there
    device_data = None
    if cfg.TRAIN.DEVICE_DATA:
        device_data, nbytes = put_split(datasets["train"])
        logger.info(f"device-resident train split: {nbytes / 1e9:.2f} GB "
                    f"on {device} ({len(datasets['train'])} rows)")
        datasets["train"] = ArrayDataset(
            {"idx": np.arange(len(datasets["train"]), dtype=np.int32)})

    # TRAIN.DEVICE_EVAL: val/test residency too — eval ships only index
    # vectors
    eval_device_data = None
    if cfg.TRAIN.DEVICE_EVAL:
        # fail fast on a split the run will evaluate but cannot serve from
        # the device
        needed = "test" if args.test else "val"
        if needed not in datasets:
            raise ValueError(
                f"TRAIN.DEVICE_EVAL=True but the '{needed}' split is absent "
                f"(have {sorted(datasets)}); provide it or disable "
                f"TRAIN.DEVICE_EVAL")
        eval_device_data = {}
        for split in ("val", "test"):
            if split not in datasets:
                continue
            labels = np.asarray(datasets[split].columns["label"])
            # labels stay on the host for the metric suite
            eval_device_data[split], nbytes = put_split(datasets[split],
                                                        drop=("label",))
            logger.info(f"device-resident {split} split: "
                        f"{nbytes / 1e9:.2f} GB on {device}")
            datasets[split] = ArrayDataset(
                {"idx": np.arange(len(labels), dtype=np.int32),
                 "label": labels})

    if args.test:
        metrics = run_eval(model, datasets["test"], B, device,
                           (eval_device_data or {}).get("test"), inputs)
        logger.info(f"TEST(only) {metrics}")
        return {"test_metrics": metrics}
    return fit(cfg=cfg, model=model, opt=opt, train_ds=datasets["train"],
               val_ds=datasets.get("val", datasets["train"]), device=device,
               test_ds=datasets.get("test"), output_dir=output_dir,
               logger=logger, device_data=device_data,
               eval_device_data=eval_device_data, inputs=inputs)


if __name__ == "__main__":
    main()
