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
  * undersample train negatives to 1:1 (val/test stay imbalanced),
  * "img_path label" manifests per partition (``write_manifests``) and
    their reader (``read_manifest``),
  * ``BigVulDataset``: a partition's view with sampling and the
    vulnerable-only filter, and its functions' ``.c`` files.
"""

from __future__ import annotations

import os
import re
from typing import TYPE_CHECKING, Optional, Tuple

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


def remove_space_before_newline(code: str) -> str:
    return re.sub(r"[ \t]+\n", "\n", code)


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


def write_manifests(df: pd.DataFrame, img_dir: str, out_dir: str,
                    label_col: str = "vul") -> Tuple[str, str, str]:
    """Write "img_path label" manifests like the reference's
    datasets/total/{train_balanced,valid,test}.txt (config.py:234-237).
    Image path convention: {img_dir}/{partition}/{buggy|clean}/{_id}.png
    (getImages.py:195-202)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for part, fname in (("train", "train_balanced.txt"), ("val", "valid.txt"),
                        ("test", "test.txt")):
        rows = df[df.label == part]
        p = os.path.join(out_dir, fname)
        with open(p, "w") as f:
            for _, r in rows.iterrows():
                sub = "buggy" if r[label_col] == 1 else "clean"
                img = os.path.join(img_dir, part, sub, f"{r._id}.png")
                f.write(f"{img} {int(r[label_col])}\n")
        paths[part] = p
    return paths["train"], paths["val"], paths["test"]


class BigVulDataset:
    """Corpus view with partition filter / sampling / vulnerable-only modes
    (reference: baselines/utils/dclass.py BigVulDataset:11-138)."""

    def __init__(self, df: pd.DataFrame, partition: str = "train",
                 sample: int = -1, vulonly: bool = False, seed: int = 0,
                 func_dir: Optional[str] = None):
        self.func_dir = func_dir
        view = df[df.label == partition] if "label" in df else df
        if vulonly:
            view = view[view.vul == 1]
        if sample > 0:
            view = view.sample(min(sample, len(view)), random_state=seed)
        self.df = view.reset_index(drop=True)
        self.partition = partition

    def __len__(self) -> int:
        return len(self.df)

    def itempath(self, _id: int) -> str:
        """Path of the function's .c file (reference: dclass.py itempath →
        processed/bigvul/func_before/{_id}.c)."""
        from mvuld_tpu_torch.tools.storage import processed_dir
        base = self.func_dir or os.path.join(processed_dir(), "bigvul",
                                             "func_before")
        return os.path.join(base, f"{_id}.c")

    def write_functions(self) -> None:
        """Materialize {_id}.c files (the processJoern input layout)."""
        for _, row in self.df.iterrows():
            p = self.itempath(int(row._id))
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "w") as f:
                f.write(row.func_before)

    def stats(self) -> dict:
        return {"n": len(self.df),
                "vul": int(self.df.vul.sum()),
                "nonvul": int((self.df.vul == 0).sum()),
                "partition": self.partition}


def read_manifest(path: str) -> pd.DataFrame:
    """Parse a "path label" manifest; _id recovered from the file stem."""
    import pandas as pd
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            img_path, label = line.rsplit(" ", 1)
            _id = int(os.path.splitext(os.path.basename(img_path))[0])
            recs.append({"_id": _id, "img_path": img_path, "vul": int(label)})
    return pd.DataFrame(recs)
