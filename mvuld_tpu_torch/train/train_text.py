"""Text-only vulnerability classifier — the cUniXcoder baseline path
(counterpart of ``mvuld_tpu/train/train_text.py``).

Mirrors baselines/models/cunixcoder/main.py: fine-tune UniXcoder + linear
2-class head on function text, best-F1 early stopping, and a
``--save-embeddings`` mode that exports per-function sentence embeddings —
the text features the fusion model consumes (reference get_representation,
cunixcoder/main.py:141-188).

The encoder runs its plain layers on every device, as the JAX trainer builds
its ``RobertaConfig`` without the fused MLP. ``--pretrained`` loads an HF
``pytorch_model.bin`` straight into the encoder: the port's RoBERTa carries
HF parameter names, so the JAX package's ``roberta_torch_to_flax`` has no
counterpart here. ``build_text_training`` makes the model, the optimizer and
the step for ``main`` and for any caller that feeds its own token ids.

Usage:
  python -m mvuld_tpu_torch.train.train_text --cfg cfg.yaml --data corpus.pkl \\
      [--synthetic N] [--save-embeddings out.pkl] [--test] \\
      [--tokenizer tok.json] [--device cuda|cpu] [--opts KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
from typing import Dict, Optional

import numpy as np


def build_text_datasets(df, tokenizer, max_length: int):
    """Tokenize each partition's functions into [N, T] id arrays."""
    from mvuld_tpu_torch.data.loader import ArrayDataset

    out = {}
    for part in ("train", "val", "test"):
        rows = df[df.label == part]
        if len(rows) == 0:
            continue
        ids = tokenizer.tokenize(rows.func_before.tolist(),
                                 max_length=max_length)
        out[part] = ArrayDataset({
            "input_ids": ids,
            "label": rows.vul.to_numpy().astype(np.int32),
            "_id": rows._id.to_numpy().astype(np.int64),
        })
    return out


def get_or_train_tokenizer(df, path: Optional[str], vocab_size: int = 8192):
    from mvuld_tpu_torch.data.tokenizer import CodeTokenizer
    if path and os.path.exists(path):
        return CodeTokenizer.load(path)
    tok = CodeTokenizer.train(df.func_before.tolist(), vocab_size=vocab_size)
    if path:
        tok.save(path)
    return tok


def roberta_config(cfg, vocab_size: int):
    """The text encoder's config from MODEL.UNIXCODER and PARALLEL.DTYPE."""
    import torch

    from mvuld_tpu_torch.models.roberta import RobertaConfig

    u = cfg.MODEL.UNIXCODER
    return RobertaConfig(
        vocab_size=max(vocab_size, 16), hidden_size=u.HIDDEN,
        num_layers=u.LAYERS, num_heads=u.HEADS,
        intermediate_size=u.INTERMEDIATE,
        max_position_embeddings=u.MAX_POSITIONS,
        dtype=(torch.bfloat16 if cfg.PARALLEL.DTYPE == "bfloat16"
               else torch.float32))


def load_pretrained_encoder(encoder, path: str) -> None:
    """An HF ``RobertaModel`` state dict (bare, or under ``encoder.`` as the
    fine-tuned cunixcoder DefectModel saves it) into ``encoder``; the pooler
    and position-id buffers are dropped, anything missing raises."""
    import torch

    sd = torch.load(path, map_location="cpu")
    prefix = ("encoder." if any(k.startswith("encoder.embeddings.")
                                for k in sd) else "")
    want = encoder.state_dict()
    got = {k[len(prefix):]: v for k, v in sd.items()
           if k.startswith(prefix) and k[len(prefix):] in want}
    missing = sorted(set(want) - set(got))
    if missing:
        raise KeyError(f"{path}: no value for {missing[:6]}"
                       f"{' …' if len(missing) > 6 else ''}")
    encoder.load_state_dict(got, strict=True)


def text_inputs(batch: Dict) -> Dict:
    """The classifier's input from a device batch."""
    return {"source_ids": batch["input_ids"].long()}


@dataclasses.dataclass
class TextTraining:
    """The text stage's model, optimizer and step (``step`` trains on a
    device batch {"input_ids", "label"})."""

    model: object
    opt: object
    label_smoothing: float
    config: object          # the RobertaConfig

    def step(self, batch, gen):
        from mvuld_tpu_torch.core.train_state import train_step
        return train_step(self.model, self.opt, batch, gen,
                          self.label_smoothing, text_inputs)


def build_text_training(cfg, datasets, vocab_size: int, device,
                        pretrained: Optional[str] = None) -> TextTraining:
    """``UniXcoderClassifier`` (layers checkpointed with
    TRAIN.USE_CHECKPOINT) initialised with the JAX initialisers from
    ``cfg.SEED`` (its encoder from ``pretrained`` when given), and AdamW with
    the config's schedule over ``datasets["train"]``'s steps per epoch."""
    import torch

    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.schedule import build_schedule
    from mvuld_tpu_torch.data.loader import steps_per_epoch
    from mvuld_tpu_torch.models import convert
    from mvuld_tpu_torch.models.unixcoder import UniXcoderClassifier

    if cfg.PARALLEL.PP > 1:
        raise NotImplementedError(
            "PARALLEL.PP > 1: the pipeline-parallel text encoder is not "
            "ported (ROADMAP Queue 1 item 7, parallel/pipeline.py)")
    rcfg = roberta_config(cfg, vocab_size)
    model = UniXcoderClassifier(rcfg, num_classes=cfg.MODEL.NUM_CLASSES,
                                remat=cfg.TRAIN.USE_CHECKPOINT)
    convert.init_jax_like(model, torch.Generator().manual_seed(cfg.SEED))
    if pretrained:
        load_pretrained_encoder(model.encoder, pretrained)
    model.to(device)
    B = cfg.DATA.BATCH_SIZE
    spe = max(steps_per_epoch(len(datasets["train"]), B), 1)
    opt = build_optimizer(cfg, build_schedule(cfg, spe, B), model)
    return TextTraining(model, opt, cfg.MODEL.LABEL_SMOOTHING, rcfg)


def export_embeddings(model, datasets, batch_size: int, device) -> Dict:
    """{_id: float32[H]} sentence embeddings of every function of every
    split, from the encoder in eval mode."""
    from mvuld_tpu_torch.train.precompute import frozen_text_encoder

    encode = frozen_text_encoder(model, device)
    reprs = {}
    for ds in datasets.values():
        ids, keys = ds.columns["input_ids"], ds.columns["_id"]
        for lo in range(0, len(ds), batch_size):
            sent = encode(np.stack([ids[j] for j in
                                    range(lo, min(lo + batch_size, len(ds)))]))
            for j, row in enumerate(sent, start=lo):
                reprs[int(keys[j])] = row
    return reprs


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--data", default=None, help="corpus pickle (pandas)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="generate N synthetic functions instead of --data")
    parser.add_argument("--hard", action="store_true",
                        help="value-binding synthetic corpus "
                             "(tools/synthetic.py hard mode)")
    parser.add_argument("--batch-size", dest="batch_size", type=int)
    parser.add_argument("--tokenizer", default=None)
    parser.add_argument("--pretrained", default=None,
                        help="HF pytorch_model.bin for the encoder")
    parser.add_argument("--save-embeddings", default=None)
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--output", default=None)
    parser.add_argument("--opts", nargs="+", default=None)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    args = parser.parse_args(argv)

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.logger import create_logger
    from mvuld_tpu_torch.train.harness import fit, run_eval
    from mvuld_tpu_torch.train.predict import resolve_device

    cfg = get_config(args)
    logger = create_logger(cfg.OUTPUT)
    device = resolve_device(args.device)

    # ---- data
    if args.synthetic:
        from mvuld_tpu_torch.tools.dataset import prepare_corpus
        from mvuld_tpu_torch.tools.synthetic import generate_dataset
        df = prepare_corpus(generate_dataset(args.synthetic,
                                             seed=cfg.SEED or 42,
                                             hard=args.hard))
    else:
        import pandas as pd
        df = pd.read_pickle(args.data)
    # the tokenizer persists next to the run so that downstream stages
    # (fusion caches, patch eval) tokenize identically
    tok_path = args.tokenizer or os.path.join(cfg.OUTPUT, "tokenizer.json")
    tok = get_or_train_tokenizer(df, tok_path)
    datasets = build_text_datasets(df, tok, cfg.DATA.FUNC_TOKENS)
    logger.info(f"dataset sizes: { {k: len(v) for k, v in datasets.items()} }")

    run = build_text_training(cfg, datasets, tok.vocab_size, device,
                              args.pretrained)
    if args.pretrained:
        logger.info(f"loaded pretrained encoder from {args.pretrained}")
    if args.test:
        metrics = run_eval(run.model, datasets["test"], cfg.DATA.BATCH_SIZE,
                           device, inputs=text_inputs)
        logger.info(f"TEST(only) {metrics}")
        return {"test_metrics": metrics}
    result = fit(cfg=cfg, model=run.model, opt=run.opt,
                 train_ds=datasets["train"],
                 val_ds=datasets.get("val", datasets["train"]), device=device,
                 test_ds=datasets.get("test"), output_dir=cfg.OUTPUT,
                 logger=logger, inputs=text_inputs)

    if args.save_embeddings:
        # per-function sentence embeddings for the fusion stage
        reprs = export_embeddings(run.model, datasets, cfg.DATA.BATCH_SIZE,
                                  device)
        os.makedirs(os.path.dirname(args.save_embeddings) or ".",
                    exist_ok=True)
        with open(args.save_embeddings, "wb") as f:
            pickle.dump(reprs, f)
        logger.info(f"saved {len(reprs)} embeddings → {args.save_embeddings}")
    result["model"] = run.model
    result["tokenizer"] = tok
    result["roberta_config"] = run.config
    return result


if __name__ == "__main__":
    main()
