"""Step-3 CLI: validate graphs, rebalance, render PNGs, write manifests.

The port's copy of ``mvuld_tpu/tools/make_images.py``, on the port's
``tools/{cpg,dataset,render,synthetic}.py``; pandas and PIL are imported
when it runs (a host tool: the GPU machine has neither).

The getImages.py equivalent (reference: baselines/scripts/getImages.py:18-271):
  * validity check (≥2 connected lines after the gtype filter — the
    check_validity analogue),
  * drop functions ≥100 lines,
  * undersample train negatives 1:1 (val/test stay imbalanced),
  * render every CPG to processed/{gtype}/{partition}/{buggy|clean}/{id}.png,
  * emit "path label" manifests (train_balanced/valid/test.txt)
  * emit per-image norm-pos pickles (the OCR oracle path).

Usage:
  python -m mvuld_tpu_torch.tools.make_images --data cleaned.pkl --out-dir storage/processed \
      [--gtype all] [--synthetic N]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default=None)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--gtype", default="all")
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    import pandas as pd

    from mvuld_tpu_torch.core.logger import create_logger
    from mvuld_tpu_torch.tools.cpg import extract_line_cpg
    from mvuld_tpu_torch.tools.dataset import (filter_by_lines, rebalance_train,
                                         write_manifests)
    from mvuld_tpu_torch.tools.render import render_cpg, save_norm_pos

    logger = create_logger(args.out_dir)
    if args.synthetic:
        from mvuld_tpu_torch.tools.dataset import prepare_corpus
        from mvuld_tpu_torch.tools.synthetic import generate_dataset
        df = prepare_corpus(generate_dataset(args.synthetic, seed=args.seed))
    else:
        df = pd.read_pickle(args.data)

    df = filter_by_lines(df, 100)

    # validity: parses and has ≥2 connected lines under the gtype filter
    keep = []
    for _, row in df.iterrows():
        cpg = extract_line_cpg(row.func_before)
        ok = cpg is not None and len(cpg.filtered(args.gtype).nodes) >= 2
        keep.append(ok)
    df = df[keep].reset_index(drop=True)
    logger.info(f"valid graphs: {len(df)}")

    df = rebalance_train(df, seed=args.seed)
    logger.info(f"after rebalance: {df.label.value_counts().to_dict()} "
                f"(train vul rate {df[df.label=='train'].vul.mean():.2f})")

    img_root = os.path.join(args.out_dir, args.gtype)
    pos_root = os.path.join(args.out_dir, "norm_pos_dict")
    os.makedirs(pos_root, exist_ok=True)
    part_name = {"train": "train", "val": "val", "test": "test"}
    for _, row in df.iterrows():
        sub = "buggy" if row.vul == 1 else "clean"
        img_path = os.path.join(img_root, part_name[row.label], sub,
                                f"{int(row._id)}.png")
        pos_path = os.path.join(pos_root, f"{int(row._id)}.pkl")
        if os.path.exists(img_path) and os.path.exists(pos_path):
            continue
        cpg = extract_line_cpg(row.func_before).filtered(args.gtype)
        _img, pos = render_cpg(cpg, out_path=img_path)
        save_norm_pos(pos, pos_path)

    manifest_dir = os.path.join(args.out_dir, "manifests")
    paths = write_manifests(df, img_root, manifest_dir)
    logger.info(f"manifests: {paths}")
    df.to_pickle(os.path.join(args.out_dir, "balanced_df.pkl"))
    return df


if __name__ == "__main__":
    main()
