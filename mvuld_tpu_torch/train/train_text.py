"""Text-only vulnerability classifier — the cUniXcoder baseline path
(counterpart of ``mvuld_tpu/train/train_text.py``).

Mirrors baselines/models/cunixcoder/main.py: fine-tune UniXcoder + linear
2-class head on function text, best-F1 early stopping, and a
``--save-embeddings`` mode that exports per-function sentence embeddings —
the text features the fusion model consumes (reference get_representation,
cunixcoder/main.py:141-188).

The encoder runs its plain layers on every device, as the JAX trainer builds
its ``RobertaConfig`` without the fused MLP. PARALLEL.PP > 1 runs the encoder
as a GPipe pipeline (``parallel/pipeline.py``) of PARALLEL.PP stages over
PARALLEL.PP_MICROBATCHES microbatches, on the same parameter tree, so its
checkpoints load into a sequential run; the pipeline owns the devices and
data parallelism is off, as in JAX. Otherwise PARALLEL.DP / MP lay the
ranks of a torchrun launch out as the JAX mesh (``parallel/mesh.py``).
``--pretrained`` loads an HF ``pytorch_model.bin`` straight into the
encoder: the port's RoBERTa carries HF parameter names, so the JAX
package's ``roberta_torch_to_flax`` has no counterpart here.
``build_text_training`` makes the model, the optimizer and the step for
``main`` and for any caller that feeds its own token ids.

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


def roberta_config(cfg, vocab_size: int, kernels: bool = False):
    """The text encoder's config from MODEL.UNIXCODER and PARALLEL.DTYPE;
    ``kernels`` with TRAIN.FUSED_MLP runs the MLP halves through K4/K4b."""
    import torch

    from mvuld_tpu_torch.models.roberta import RobertaConfig

    u = cfg.MODEL.UNIXCODER
    return RobertaConfig(
        vocab_size=max(vocab_size, 16), hidden_size=u.HIDDEN,
        num_layers=u.LAYERS, num_heads=u.HEADS,
        intermediate_size=u.INTERMEDIATE,
        max_position_embeddings=u.MAX_POSITIONS,
        use_pallas_mlp=kernels and cfg.TRAIN.FUSED_MLP,
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

    mesh: object = None     # the dp/mp mesh, None under the pipeline

    def step(self, batch, gen):
        from mvuld_tpu_torch.core.train_state import train_step
        return train_step(self.model, self.opt, batch, gen,
                          self.label_smoothing, text_inputs, mesh=self.mesh)


def pipelined_classifier(config, num_classes: int, stages: int,
                         microbatches: int, remat: bool, devices=None):
    """A ``UniXcoderClassifier`` whose encoder runs as a GPipe pipeline of
    ``stages`` stages over ``microbatches`` microbatches (``devices``: the
    stages' devices, ``make_pp_mesh``'s default when None). Its parameters
    and state dict are the sequential classifier's. In training the
    dropout keys come from one seed drawn from the step's generator."""
    import torch

    from mvuld_tpu_torch.models.dropout import base_generator
    from mvuld_tpu_torch.models.roberta import masked_mean
    from mvuld_tpu_torch.models.swin_v2 import linear
    from mvuld_tpu_torch.models.unixcoder import UniXcoderClassifier
    from mvuld_tpu_torch.parallel.pipeline import (make_pp_mesh,
                                                   roberta_pipeline_forward)

    class PipelinedClassifier(UniXcoderClassifier):
        def __init__(self):
            super().__init__(config, num_classes)
            self.pp_mesh = make_pp_mesh(stages, devices)

        def forward(self, source_ids, train=False, gen=None):
            ids = source_ids.long()
            mask = (ids != config.pad_token_id).long()
            seed = (int(torch.randint(0, 2 ** 62, (1,),
                                      generator=base_generator(gen),
                                      device=gen.device).item())
                    if train and gen is not None else None)
            tokens = roberta_pipeline_forward(
                self.encoder, ids, mask, self.pp_mesh, microbatches,
                remat=remat, dropout_rng=seed)
            sent = masked_mean(tokens, mask)
            return linear(sent, self.classifier, config.dtype).float(), sent

    return PipelinedClassifier()


def build_text_training(cfg, datasets, vocab_size: int, device,
                        pretrained: Optional[str] = None,
                        mesh=None, kernels: bool = False) -> TextTraining:
    """``UniXcoderClassifier`` (layers checkpointed with
    TRAIN.USE_CHECKPOINT) initialised with the JAX initialisers from
    ``cfg.SEED`` (its encoder from ``pretrained`` when given), and AdamW with
    the config's schedule over ``datasets["train"]``'s steps per epoch.
    PARALLEL.PP > 1: the pipelined classifier, its stages over the
    visible cards (``make_pp_mesh``; all of them on a one-card host) or on
    the CPU; else ``mesh`` (``parallel/mesh.py``): its parameters
    broadcast from rank 0 and the step data-parallel. ``kernels`` with
    TRAIN.FUSED_MLP runs the encoder's MLP halves through K4/K4b (the CLI
    keeps the JAX trainer's plain layers)."""
    import torch

    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.schedule import build_schedule
    from mvuld_tpu_torch.data.loader import steps_per_epoch
    from mvuld_tpu_torch.models import convert
    from mvuld_tpu_torch.models.unixcoder import UniXcoderClassifier
    from mvuld_tpu_torch.parallel.mesh import replicate

    rcfg = roberta_config(cfg, vocab_size, kernels)
    if cfg.PARALLEL.PP > 1:
        model = pipelined_classifier(
            rcfg, cfg.MODEL.NUM_CLASSES, cfg.PARALLEL.PP,
            cfg.PARALLEL.PP_MICROBATCHES, cfg.TRAIN.USE_CHECKPOINT,
            None if device.type == "cuda" else [device])
        mesh = None
    else:
        model = UniXcoderClassifier(rcfg, num_classes=cfg.MODEL.NUM_CLASSES,
                                    remat=cfg.TRAIN.USE_CHECKPOINT)
    convert.init_jax_like(model, torch.Generator().manual_seed(cfg.SEED))
    if pretrained:
        load_pretrained_encoder(model.encoder, pretrained)
    model.to(device)
    if cfg.PARALLEL.PP > 1:
        from mvuld_tpu_torch.parallel.pipeline import place_stages
        place_stages(model.encoder, model.pp_mesh)
    if mesh is not None:
        replicate(mesh, model)
    B = cfg.DATA.BATCH_SIZE
    spe = max(steps_per_epoch(len(datasets["train"]), B), 1)
    opt = build_optimizer(cfg, build_schedule(cfg, spe, B), model)
    return TextTraining(model, opt, cfg.MODEL.LABEL_SMOOTHING, rcfg, mesh)


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
    from mvuld_tpu_torch.parallel.distributed import local_device
    from mvuld_tpu_torch.parallel.mesh import mesh_from_cfg, primary_first
    from mvuld_tpu_torch.train.harness import fit, run_eval
    from mvuld_tpu_torch.train.predict import resolve_device

    cfg = get_config(args)
    device = resolve_device(args.device)
    # the pipeline owns the devices: no dp mesh under PARALLEL.PP > 1
    mesh = mesh_from_cfg(cfg, device) if cfg.PARALLEL.PP <= 1 else None
    primary = mesh is None or mesh.is_primary
    device = local_device(device)
    logger = create_logger(cfg.OUTPUT if primary else "",
                           0 if primary else mesh.rank)

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
    with primary_first(mesh):
        tok = get_or_train_tokenizer(df, tok_path)
    datasets = build_text_datasets(df, tok, cfg.DATA.FUNC_TOKENS)
    logger.info(f"dataset sizes: { {k: len(v) for k, v in datasets.items()} }")

    run = build_text_training(cfg, datasets, tok.vocab_size, device,
                              args.pretrained, mesh)
    if args.pretrained:
        logger.info(f"loaded pretrained encoder from {args.pretrained}")
    if args.test:
        metrics = run_eval(run.model, datasets["test"], cfg.DATA.BATCH_SIZE,
                           device, inputs=text_inputs, mesh=mesh)
        logger.info(f"TEST(only) {metrics}")
        return {"test_metrics": metrics}
    result = fit(cfg=cfg, model=run.model, opt=run.opt,
                 train_ds=datasets["train"],
                 val_ds=datasets.get("val", datasets["train"]), device=device,
                 test_ds=datasets.get("test"), output_dir=cfg.OUTPUT,
                 logger=logger, inputs=text_inputs, mesh=mesh)

    if args.save_embeddings and primary:
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
