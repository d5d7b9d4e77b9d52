"""Dataset cleaning, splitting, rebalancing — Big-Vul pipeline semantics.

A copy of the corpus funnel of ``mvuld_tpu/tools/dataset.py`` (the port
imports nothing of the JAX package); pandas is imported only where a
function needs it, since the GPU machine has none.

Replicates the reference's offline steps (reference:
baselines/scripts/process_dataset.py:22-174, baselines/utils/utils.py:30-209,
baselines/scripts/getImages.py:53-99):

  * code cleaning: strip comments / blank lines / trailing whitespace,
  * dedup by function text,
  * stratified 80/10/10 split with a fixed seed (default 42),
  * drop functions with ≥ ``max_lines`` lines (default 100),
  * undersample train negatives to 1:1 (val/test stay imbalanced).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from mvuld_tpu_torch.tools.cpg import clean_code

if TYPE_CHECKING:
    import pandas as pd


def clean_function(code: str) -> str:
    """Remove comments, collapse blank lines, strip trailing whitespace."""
    lines = clean_code(code)
    out = []
    for line in lines:
        line = line.rstrip()
        if line.strip() == "":
            continue
        out.append(line)
    return "\n".join(out)


def dedup(df: pd.DataFrame, col: str = "func_before") -> pd.DataFrame:
    return df.drop_duplicates(subset=[col]).reset_index(drop=True)


def filter_by_lines(df: pd.DataFrame, max_lines: int = 100,
                    col: str = "func_before") -> pd.DataFrame:
    """Drop functions with >= max_lines source lines (getImages.py:53-60)."""
    nlines = df[col].map(lambda c: len(c.splitlines()))
    return df[nlines < max_lines].reset_index(drop=True)


def train_val_test_split(df: pd.DataFrame, seed: int = 42,
                         frac_train: float = 0.8, frac_val: float = 0.1,
                         label_col: str = "vul") -> pd.DataFrame:
    """Stratified 80/10/10 split; adds a ``label`` column with
    train/val/test (reference: utils.py train_val_test_split_df:180-209)."""
    rng = np.random.RandomState(seed)
    df = df.copy()
    df["label"] = "train"
    for cls, group in df.groupby(label_col):
        idx = group.index.to_numpy().copy()
        rng.shuffle(idx)
        n = len(idx)
        n_train = int(round(n * frac_train))
        n_val = int(round(n * frac_val))
        df.loc[idx[n_train:n_train + n_val], "label"] = "val"
        df.loc[idx[n_train + n_val:], "label"] = "test"
    return df


def rebalance_train(df: pd.DataFrame, seed: int = 42, ratio: float = 1.0,
                    label_col: str = "vul") -> pd.DataFrame:
    """Undersample train negatives to ``ratio``× positives; keep val/test
    imbalanced (reference: getImages.py rebalanceData:80-99)."""
    import pandas as pd

    rng = np.random.RandomState(seed)
    train = df[df.label == "train"]
    pos = train[train[label_col] == 1]
    neg = train[train[label_col] == 0]
    keep = min(len(neg), int(round(len(pos) * ratio)))
    neg_idx = rng.choice(neg.index.to_numpy(), size=keep, replace=False)
    kept = pd.concat([pos, train.loc[neg_idx]]).sort_index()
    return pd.concat([kept, df[df.label != "train"]]).reset_index(drop=True)


def prepare_corpus(df: pd.DataFrame, seed: int = 42, max_lines: int = 100
                   ) -> pd.DataFrame:
    """Full cleaning funnel: clean → drop-unchanged-vul → dedup → line filter
    → split → rebalance (reference: cleaned_dataset, process_dataset.py:32-56)."""
    df = df.copy()
    df["func_before"] = df["func_before"].map(clean_function)
    if "func_after" in df.columns and "vul" in df.columns:
        df["func_after"] = df["func_after"].map(
            lambda c: clean_function(c) if isinstance(c, str) else c)
        # vul rows whose fix changed nothing are mislabeled — drop them
        # (reference: process_dataset.py:42)
        df = df[(df.vul == 0) | (df.func_before != df.func_after)]
        df = df.reset_index(drop=True)
    df = dedup(df)
    df = filter_by_lines(df, max_lines)
    df = train_val_test_split(df, seed=seed)
    df = rebalance_train(df, seed=seed)
    return df
