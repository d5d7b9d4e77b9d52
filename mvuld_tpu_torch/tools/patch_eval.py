"""Patched-function evaluation — the eval_patches.py equivalent.

A copy of ``mvuld_tpu/tools/patch_eval.py`` (the port imports nothing of
the JAX package); matplotlib and sklearn are imported only inside
``plot_embedding``.

The reference evaluates trained detectors on the PATCHED (func_after)
versions of vulnerable functions to measure whether the model tracks the fix
(reference: baselines/scripts/eval_patches.py:38-615, vuln-only datasets).
Here the synthetic generator provides exact (vulnerable, fixed) twins, and
any real corpus with a ``func_after`` column works identically.

Given a probability function P(vul|code), reports:
  * vul_detection_rate  — P>0.5 on the vulnerable versions,
  * patch_clean_rate    — P≤0.5 on the patched versions,
  * flip_rate           — pairs where the prediction flips vul→clean
                          (the reference's headline patch metric),
  * mean probability drop after patching.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


def make_patch_pairs(n: int, seed: int = 0) -> Tuple[List[str], List[str]]:
    """Synthetic (vulnerable, fixed) twins from the template generator."""
    import random

    from mvuld_tpu_torch.tools.synthetic import _TEMPLATES, _mk

    rng = random.Random(seed)
    vul, fixed = [], []
    while len(vul) < n:
        vul_body, fix_body = _TEMPLATES[rng.randrange(len(_TEMPLATES))]
        v = _mk(rng)
        vul.append(vul_body.format(**v))
        fixed.append(fix_body.format(**v))
    return vul, fixed


def evaluate_patches(prob_fn: Callable[[Sequence[str]], np.ndarray],
                     vul_codes: Sequence[str], patched_codes: Sequence[str]
                     ) -> Dict[str, float]:
    """prob_fn: list of source strings → P(vul) array."""
    p_vul = np.asarray(prob_fn(list(vul_codes)), np.float64)
    p_fix = np.asarray(prob_fn(list(patched_codes)), np.float64)
    pred_vul = p_vul > 0.5
    pred_fix = p_fix > 0.5
    flips = pred_vul & ~pred_fix
    return {
        "n_pairs": len(p_vul),
        "vul_detection_rate": float(pred_vul.mean()),
        "patch_clean_rate": float((~pred_fix).mean()),
        "flip_rate": float(flips.sum() / max(pred_vul.sum(), 1)),
        "mean_prob_drop": float((p_vul - p_fix).mean()),
    }


def plot_embedding(features: np.ndarray, labels: Sequence[int], out_path: str,
                   title: str = "t-SNE of function representations") -> str:
    """2-D t-SNE scatter of learned representations (the reference's
    eval_patches plot_embedding, eval_patches.py:38-615)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    feats = np.asarray(features, np.float32)
    labels = np.asarray(labels)
    perplexity = max(2, min(30, len(feats) // 4))
    emb = TSNE(n_components=2, random_state=0,
               perplexity=perplexity).fit_transform(feats)
    fig, ax = plt.subplots(figsize=(6, 5))
    for cls, color, name in ((0, "#4878CF", "clean"), (1, "#D65F5F", "vulnerable")):
        m = labels == cls
        ax.scatter(emb[m, 0], emb[m, 1], s=12, c=color, label=name, alpha=0.7)
    ax.legend()
    ax.set_title(title)
    import os
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
