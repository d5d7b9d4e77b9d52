"""Step-1 dataset preparation CLI — the process_dataset.py equivalent.

Counterpart of ``mvuld_tpu/tools/process_dataset.py``: the corpus funnel is
host code over pandas (imported inside ``main``); ``--glove`` and
``--w2v`` train the embeddings on ``--device`` (default cuda) and write the
same ``embeddings/{glove,w2v}.npz``.

Reads a Big-Vul-format CSV/pickle (columns func_before [, func_after, vul]),
runs the cleaning funnel (reference: baselines/scripts/process_dataset.py:
22-174): clean → dedup → diff-info → abnormal filter → stratified 80/10/10
split (seed 42) → optional mutation augmentation → optional GloVe/word2vec
training on the train split → writes the cleaned pickle.

Usage:
  python -m mvuld_tpu_torch.tools.process_dataset --input MSR_data_cleaned.csv \
      --output storage/cache/bigvul_cleaned.pkl [--synthetic N]
      [--augment] [--glove] [--w2v] [--seed 42] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", default=None, help=".csv or .pkl")
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--output", required=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--max-lines", type=int, default=100)
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--glove", action="store_true")
    parser.add_argument("--w2v", action="store_true")
    parser.add_argument("--emb-dim", type=int, default=100)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu: where the embeddings "
                             "train")
    args = parser.parse_args(argv)

    import pandas as pd

    from mvuld_tpu_torch.core.logger import create_logger
    from mvuld_tpu_torch.tools.dataset import prepare_corpus
    from mvuld_tpu_torch.tools.gitdiff import mark_vulnerable_lines
    from mvuld_tpu_torch.train.predict import resolve_device

    device = resolve_device(args.device)
    logger = create_logger(os.path.dirname(args.output) or ".")

    if args.synthetic:
        from mvuld_tpu_torch.tools.synthetic import generate_dataset
        df = generate_dataset(args.synthetic, seed=args.seed)
    elif args.input.endswith(".csv"):
        df = pd.read_csv(args.input)
    else:
        df = pd.read_pickle(args.input)
    if "_id" not in df.columns:
        df = df.reset_index().rename(columns={"index": "_id"})
    if "vul" not in df.columns:
        raise SystemExit("input needs a 'vul' column")
    logger.info(f"loaded {len(df)} rows")

    if "func_after" in df.columns:
        df = mark_vulnerable_lines(df)
        logger.info("attached before/after diff line info")

    df = prepare_corpus(df, seed=args.seed, max_lines=args.max_lines)
    logger.info(f"after funnel: {len(df)} rows "
                f"({df.label.value_counts().to_dict()})")

    if args.augment:
        from mvuld_tpu_torch.tools.mutate import augment_dataframe
        train_aug = augment_dataframe(df[df.label == "train"], seed=args.seed)
        df = pd.concat([train_aug, df[df.label != "train"]], ignore_index=True)
        logger.info(f"after augmentation: {len(df)} rows")

    train_corpus = df[df.label == "train"].func_before.tolist()
    emb_dir = os.path.join(os.path.dirname(args.output) or ".", "embeddings")
    if args.glove:
        from mvuld_tpu_torch.tools.embeddings import train_glove
        emb = train_glove(train_corpus, dim=args.emb_dim, device=device)
        os.makedirs(emb_dir, exist_ok=True)
        import numpy as np
        np.savez(os.path.join(emb_dir, "glove.npz"), vectors=emb.vectors,
                 vocab=list(emb.vocab.keys()))
        logger.info(f"trained GloVe ({len(emb.vocab)} tokens)")
    if args.w2v:
        from mvuld_tpu_torch.tools.embeddings import train_sgns
        emb = train_sgns(train_corpus, dim=args.emb_dim, device=device)
        os.makedirs(emb_dir, exist_ok=True)
        import numpy as np
        np.savez(os.path.join(emb_dir, "w2v.npz"), vectors=emb.vectors,
                 vocab=list(emb.vocab.keys()))
        logger.info(f"trained word2vec ({len(emb.vocab)} tokens)")

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    df.to_pickle(args.output)
    logger.info(f"wrote {args.output}")
    return df


if __name__ == "__main__":
    main()
