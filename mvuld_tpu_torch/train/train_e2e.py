"""End-to-end tri-modal trainer: UniXcoder, SwinV2 and the fusion head
trained jointly (counterpart of ``mvuld_tpu/train/train_e2e.py``).

Usage:
  python -m mvuld_tpu_torch.train.train_e2e --synthetic N --output DIR \\
      [--device cuda|cpu] [--opts KEY VALUE ...]

On a CUDA device the model runs the port's kernels (K1/K2 attention, and
with TRAIN.FUSED_MLP the K3/K3b and K4/K4b MLP halves); on the CPU it runs
the plain layers, as the JAX trainer runs its XLA path off the TPU. A run
whose output directory already holds ``cache/e2e.npz`` (matching the
config) and ``tokenizer.json`` starts from them and needs neither pandas
nor PIL nor the ``tokenizers`` package — the way to train on a machine
that has none of them: build the cache elsewhere with ``--cache-only``,
copy the output directory, and rerun there without ``--synthetic`` or
``--data``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np

from mvuld_tpu_torch.data.loader import ArrayDataset

COLUMNS = ("func_ids", "node_ids", "image", "pos", "adj", "node_mask",
           "label")


def _load_cache(cache_path: str, cfg, img_size: int, logger=None
                ) -> Optional[Dict]:
    """The cache's arrays if they match the config, else None: a config
    change (IMG_SIZE, MAX_NODES, token budgets, NODE_CONTEXT, NODE_NUMERIC)
    between runs sharing an output directory invalidates it."""
    if not os.path.exists(cache_path):
        return None
    M, T, Tn = cfg.DATA.MAX_NODES, cfg.DATA.FUNC_TOKENS, cfg.DATA.NODE_TOKENS
    arrs = dict(np.load(cache_path, allow_pickle=True))
    if (arrs["image"].shape[1:3] == (img_size, img_size)
            and arrs["node_ids"].shape[1:] == (M, Tn)
            and arrs["func_ids"].shape[1] == T
            and arrs["pos"].shape[-1] == 4 + 2 * int(cfg.DATA.NODE_NUMERIC)
            and str(arrs.get("node_context", "none")) == cfg.DATA.NODE_CONTEXT):
        return arrs
    if logger:
        logger.warning(f"e2e cache dims {arrs['image'].shape[1]}px/"
                       f"{arrs['node_ids'].shape[1:]} != config "
                       f"{img_size}px/({M}, {Tn}) — rebuilding {cache_path}")
    return None


def build_e2e_cache(df, cfg, tok, cache_path: str, img_size: int,
                    logger=None) -> Dict:
    """Token ids + resized images + graph arrays per partition (npz)."""
    from mvuld_tpu_torch.data.graph_batch import pack_graph
    from mvuld_tpu_torch.data.tokenizer import normalize_line
    from mvuld_tpu_torch.data.transforms import load_image, resize_normalize
    from mvuld_tpu_torch.tools.cpg import dep_context_lines, extract_line_cpg
    from mvuld_tpu_torch.tools.render import load_norm_pos
    from mvuld_tpu_torch.train.precompute import render_corpus

    arrs = _load_cache(cache_path, cfg, img_size, logger)
    if arrs is not None:
        return arrs
    M, T, Tn = cfg.DATA.MAX_NODES, cfg.DATA.FUNC_TOKENS, cfg.DATA.NODE_TOKENS
    node_context = cfg.DATA.NODE_CONTEXT
    node_numeric = int(cfg.DATA.NODE_NUMERIC)
    img_dir = os.path.join(os.path.dirname(cache_path), "imgs")
    pos_dir = os.path.join(os.path.dirname(cache_path), "pos")
    paths = render_corpus(df, img_dir, pos_dir, cfg.DATA.GTYPE, logger)
    rows = df[df._id.isin(paths)]
    n = len(rows)
    arrs = {
        "func_ids": np.full((n, T), tok.pad_id, np.int32),
        "node_ids": np.full((n, M, Tn), tok.pad_id, np.int32),
        "image": np.zeros((n, img_size, img_size, 3), np.float32),
        "pos": np.zeros((n, M, 4 + 2 * node_numeric), np.float32),
        "adj": np.zeros((n, M, M), np.uint8),
        "node_mask": np.zeros((n, M), np.float32),
        "label": rows.vul.to_numpy().astype(np.int32),
        "part": rows.label.to_numpy(),
    }
    for i, (_, row) in enumerate(rows.iterrows()):
        _id = int(row._id)
        cpg = extract_line_cpg(row.func_before)
        pg = pack_graph(cpg, M, pos_dict=load_norm_pos(
            os.path.join(pos_dir, f"{_id}.pkl")), gtype=cfg.DATA.GTYPE)
        arrs["pos"][i, :, :4], arrs["adj"][i] = pg.pos, pg.adj
        arrs["node_mask"][i] = pg.mask
        arrs["func_ids"][i] = tok.tokenize([row.func_before], max_length=T)[0]
        lines = row.func_before.split("\n")
        lns = pg.lineno[: pg.num_nodes]
        if node_numeric:
            from mvuld_tpu_torch.tools.cpg import numeric_literal_feats
            arrs["pos"][i, : pg.num_nodes, 4:] = numeric_literal_feats(
                cpg, lns, lines, k=node_numeric)
        if node_context == "deps":
            node_lines = [normalize_line(s)
                          for s in dep_context_lines(cpg, lns, lines)]
        else:
            node_lines = [normalize_line(lines[ln - 1])
                          if 1 <= ln <= len(lines) else "" for ln in lns]
        if node_lines:
            arrs["node_ids"][i, : pg.num_nodes] = tok.tokenize(
                node_lines, max_length=Tn)
        arrs["image"][i] = resize_normalize(load_image(paths[_id]), img_size)
    arrs["node_context"] = np.asarray(node_context)
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    np.savez_compressed(cache_path, **arrs)
    return arrs


def build_e2e_model(cfg, vocab_size: int, node_capacity=None, **overrides):
    """EndToEndMVulD + its Roberta/Swin configs from one resolved config, so
    a finished run's config.json rebuilds the exact parameter tree (the
    trainer and the serving CLI share it). ``roberta_pallas_mlp`` turns on
    the text encoder's fused MLP (K4); the other overrides are
    EndToEndMVulD keywords (``use_pallas``, ``use_pallas_mlp``,
    ``window_resident``). TRAIN.USE_CHECKPOINT with TRAIN.REMAT_STAGES
    (empty: every stage) picks the checkpointed SwinV2 stages;
    TRAIN.TEXT_REMAT (auto: follow TRAIN.USE_CHECKPOINT) checkpoints the
    RoBERTa layers."""
    import torch

    from mvuld_tpu_torch.models.e2e import EndToEndMVulD
    from mvuld_tpu_torch.models.roberta import RobertaConfig
    from mvuld_tpu_torch.models.swin_v2 import SwinV2Config

    u = cfg.MODEL.UNIXCODER
    rcfg = RobertaConfig(
        vocab_size=max(vocab_size, 16), hidden_size=u.HIDDEN,
        num_layers=u.LAYERS, num_heads=u.HEADS,
        intermediate_size=u.INTERMEDIATE,
        max_position_embeddings=u.MAX_POSITIONS,
        use_pallas_mlp=overrides.pop("roberta_pallas_mlp", False),
        dtype=(torch.bfloat16 if cfg.PARALLEL.DTYPE == "bfloat16"
               else torch.float32))
    scfg = SwinV2Config.from_cfg(cfg)
    remat = ((tuple(cfg.TRAIN.REMAT_STAGES)
              or tuple(range(len(scfg.depths))))
             if cfg.TRAIN.USE_CHECKPOINT else ())
    kwargs = dict(hidden=cfg.MODEL.MULTI.HIDDEN,
                  num_classes=cfg.MODEL.NUM_CLASSES,
                  num_rs_gcn=cfg.MODEL.MULTI.NUM_RS_GCN,
                  num_hidden=cfg.MODEL.MULTI.NUM_HIDDEN_FC,
                  max_nodes=cfg.DATA.MAX_NODES,
                  pos_dim=4 + 2 * int(cfg.DATA.NODE_NUMERIC),
                  node_capacity=node_capacity, swin_remat_stages=remat,
                  text_remat={"auto": bool(cfg.TRAIN.USE_CHECKPOINT),
                              "on": True, "off": False}[cfg.TRAIN.TEXT_REMAT])
    kwargs.update(overrides)
    return EndToEndMVulD(rcfg, scfg, **kwargs), rcfg, scfg


def _corpus(args, cfg):
    if args.synthetic:
        from mvuld_tpu_torch.tools.dataset import prepare_corpus
        from mvuld_tpu_torch.tools.synthetic import generate_dataset
        return prepare_corpus(generate_dataset(args.synthetic,
                                               seed=cfg.SEED or 42,
                                               hard=args.hard))
    if not args.data:
        raise ValueError("no usable cache/e2e.npz and tokenizer.json in the "
                         "output directory: pass --synthetic N or --data")
    import pandas as pd
    return pd.read_pickle(args.data)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--hard", action="store_true",
                        help="value-binding synthetic corpus "
                             "(tools/synthetic.py hard mode)")
    parser.add_argument("--data", default=None)
    parser.add_argument("--batch-size", dest="batch_size", type=int)
    parser.add_argument(
        "--node-capacity", dest="node_capacity", type=int, default=-1,
        help="static packed size for the per-line encoder: -1 auto-sizes "
             "from the train split (1.25x mean valid lines per batch, "
             "rounded up to 128), 0 disables packing (encode every slot)")
    parser.add_argument("--output", default=None)
    parser.add_argument("--opts", nargs="+", default=None)
    parser.add_argument(
        "--cache-only", dest="cache_only", action="store_true",
        help="build the corpus cache (renders, token ids, graph arrays) and "
             "tokenizer, then exit without training")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (the plain layers)")
    args = parser.parse_args(argv)

    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.logger import create_logger
    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.schedule import build_schedule
    from mvuld_tpu_torch.data.loader import steps_per_epoch
    from mvuld_tpu_torch.data.tokenizer import vocab_size_of
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.train.harness import fit
    from mvuld_tpu_torch.train.predict import resolve_device

    cfg = get_config(args)
    logger = create_logger(cfg.OUTPUT)
    device = resolve_device(args.device)

    # the tokenizer persists next to the checkpoints: the predict CLI must
    # tokenize new functions with the training vocabulary
    tok_path = os.path.join(cfg.OUTPUT, "tokenizer.json")
    cache_path = os.path.join(cfg.OUTPUT, "cache", "e2e.npz")
    cache = _load_cache(cache_path, cfg, cfg.DATA.IMG_SIZE, logger)
    if cache is not None and os.path.exists(tok_path):
        vocab = vocab_size_of(tok_path)
        n_functions = len(cache["label"])
    else:
        from mvuld_tpu_torch.train.train_text import get_or_train_tokenizer
        df = _corpus(args, cfg)
        tok = get_or_train_tokenizer(df, tok_path, vocab_size=4096)
        cache = build_e2e_cache(df, cfg, tok, cache_path, cfg.DATA.IMG_SIZE,
                                logger)
        vocab, n_functions = tok.vocab_size, len(df)
    if args.cache_only:
        logger.info("cache-only: corpus cache + tokenizer written; exiting")
        return {"cache_only": True, "n_functions": n_functions,
                "output": cfg.OUTPUT}
    datasets = {}
    for part in ("train", "val", "test"):
        sel = np.asarray(cache["part"]) == part
        if sel.any():
            datasets[part] = ArrayDataset({k: np.asarray(cache[k])[sel]
                                           for k in COLUMNS})
    logger.info(f"dataset sizes: { {k: len(v) for k, v in datasets.items()} }")

    B = cfg.DATA.BATCH_SIZE
    max_nodes = datasets["train"].columns["node_mask"].shape[1]
    if args.node_capacity < 0:
        mean_valid = float(datasets["train"].columns["node_mask"].sum(1).mean())
        cap = int(np.ceil(1.25 * B * max(mean_valid, 1.0) / 128) * 128)
        node_capacity = min(cap, B * max_nodes)
    else:
        node_capacity = min(args.node_capacity, B * max_nodes) or None
    logger.info(f"node-line packing capacity: {node_capacity} "
                f"(of {B * max_nodes} slots)")
    kernels = device.type == "cuda"
    model, _, _ = build_e2e_model(
        cfg, vocab, node_capacity=node_capacity, use_pallas=kernels,
        roberta_pallas_mlp=kernels and cfg.TRAIN.FUSED_MLP,
        use_pallas_mlp=kernels and cfg.TRAIN.FUSED_MLP)
    init_jax_like(model, torch.Generator().manual_seed(cfg.SEED))
    model.to(device)

    spe = max(steps_per_epoch(len(datasets["train"]), B), 1)
    opt = build_optimizer(cfg, build_schedule(cfg, spe, B), model)

    def put(cols, drop=()):
        """Columns as device tensors (images in the compute dtype)."""
        img_dt = (torch.bfloat16 if cfg.PARALLEL.DTYPE == "bfloat16"
                  else torch.float32)
        return {k: torch.as_tensor(v).to(device, img_dt if k == "image"
                                      else None)
                for k, v in cols.items() if k not in drop}

    # TRAIN.DEVICE_DATA / DEVICE_EVAL: the splits live on the device and
    # batches become row-index vectors gathered there
    device_data = eval_device_data = None
    if cfg.TRAIN.DEVICE_DATA:
        device_data = put(datasets["train"].columns)
        datasets["train"] = ArrayDataset(
            {"idx": np.arange(len(datasets["train"]), dtype=np.int32)})
    if cfg.TRAIN.DEVICE_EVAL:
        if "val" not in datasets:
            raise ValueError(
                "TRAIN.DEVICE_EVAL=True but no 'val' split exists "
                f"(have {sorted(datasets)}); provide one or disable "
                "TRAIN.DEVICE_EVAL")
        eval_device_data = {}
        for split in ("val", "test"):
            if split in datasets:
                cols = datasets[split].columns
                eval_device_data[split] = put(cols, drop=("label",))
                datasets[split] = ArrayDataset(
                    {"idx": np.arange(len(datasets[split]), dtype=np.int32),
                     "label": np.asarray(cols["label"])})
    return fit(cfg=cfg, model=model, opt=opt, train_ds=datasets["train"],
               val_ds=datasets.get("val", datasets["train"]), device=device,
               test_ds=datasets.get("test"), output_dir=cfg.OUTPUT,
               logger=logger, device_data=device_data,
               eval_device_data=eval_device_data)


if __name__ == "__main__":
    main()
