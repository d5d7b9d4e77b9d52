"""Checkpoint save/load with the reference's resume ladder.

Counterpart of ``mvuld_tpu/core/checkpoint.py`` (reference
mvuld/utils.py:143-211) with ``torch.save`` files under the JAX package's
names: epoch checkpoints ``checkpoints/ckpt_epoch_{n}`` and best-F1
checkpoints ``checkpoint-best-f1/best_f1_epoch_{n}``, each holding the
model's state dict ("params", parameters and BatchNorm statistics), the
optimizer state ("opt_state", or None), "step", "epoch" and "best_f1".
A port checkpoint is one file; the JAX package's are orbax directories
under the same names, which the helpers below pass over.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def save_checkpoint(output_dir: str, epoch: int, tree: Dict,
                    best: bool = False) -> str:
    sub = "checkpoint-best-f1" if best else "checkpoints"
    name = f"best_f1_epoch_{epoch}" if best else f"ckpt_epoch_{epoch}"
    path = os.path.abspath(os.path.join(output_dir, sub, name))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict:
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def _newest(dirpath: str, prefix: str) -> Optional[str]:
    if not os.path.isdir(dirpath):
        return None
    cands = [os.path.join(dirpath, d) for d in os.listdir(dirpath)
             if d.startswith(prefix) and not d.endswith(".tmp")]
    cands = [c for c in cands if os.path.isfile(c)]
    return max(cands, key=os.path.getmtime) if cands else None


def auto_resume_helper(output_dir: str) -> Optional[str]:
    """Newest epoch checkpoint by mtime (reference: utils.py:201-211)."""
    return _newest(os.path.join(output_dir, "checkpoints"), "ckpt_epoch_")


def resume_bestf1_helper(output_dir: str) -> Optional[str]:
    """Newest best-f1 checkpoint by mtime (reference: utils.py:186-199)."""
    return _newest(os.path.join(output_dir, "checkpoint-best-f1"),
                   "best_f1_epoch_")


def resume_ladder(output_dir: str, model_resume: str = "",
                  best_resume: bool = True, auto_resume: bool = False
                  ) -> Optional[str]:
    """The reference's resume priority (main.py:147-191): explicit
    MODEL.RESUME > BEST_RESUME > AUTO_RESUME."""
    if model_resume:
        return model_resume
    if best_resume:
        found = resume_bestf1_helper(output_dir)
        if found:
            return found
    if auto_resume:
        return auto_resume_helper(output_dir)
    return None


def restore(path: str, model, opt=None) -> Dict:
    """Load a checkpoint into ``model`` (and ``opt`` when it holds optimizer
    state); returns {"epoch", "best_f1", "step"} (−1 / −inf when absent)."""
    tree = load_checkpoint(path)
    model.load_state_dict(tree["params"])
    if opt is not None and tree.get("opt_state") is not None:
        opt.load_state_dict(tree["opt_state"])
    return {"epoch": int(tree.get("epoch", -1)),
            "best_f1": float(tree.get("best_f1", float("-inf"))),
            "step": int(tree.get("step", 0))}
