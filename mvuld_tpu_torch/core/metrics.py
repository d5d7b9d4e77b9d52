"""Classification metric suite (pure numpy, no sklearn dependency at runtime),
a copy of ``mvuld_tpu/core/metrics.py``.

Replicates the reference's canonical numbers exactly (SURVEY §5):
  * hard metrics at the decision rule P(vul) > 0.5 on softmax prob
    (reference: mvuld/main_bigvul.py:447),
  * PR-AUC = ``average_precision_score(y, prob[:, 1], pos_label=1)``
    (reference: mvuld/main_bigvul.py:495),
  * ROC-AUC, best-F1 threshold search (reference: mvuld/ml.py:21-89).

All functions take numpy arrays (host-side, after device gather) — metrics are
intentionally NOT traced: they run once per validation epoch on small vectors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def softmax(logits: np.ndarray, axis: int = -1) -> np.ndarray:
    z = logits - logits.max(axis=axis, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=axis, keepdims=True)


def confusion_counts(y_true: np.ndarray, y_pred: np.ndarray):
    y_true = np.asarray(y_true).astype(np.int64)
    y_pred = np.asarray(y_pred).astype(np.int64)
    tp = int(np.sum((y_pred == 1) & (y_true == 1)))
    fp = int(np.sum((y_pred == 1) & (y_true == 0)))
    fn = int(np.sum((y_pred == 0) & (y_true == 1)))
    tn = int(np.sum((y_pred == 0) & (y_true == 0)))
    return tp, fp, fn, tn


def get_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    """Threshold-dependent metrics from hard predictions.

    Matches the reference's manual TP/FP/FN computation
    (mvuld/main_bigvul.py:460-483): precision/recall/F1 are 0 when undefined.
    """
    tp, fp, fn, tn = confusion_counts(y_true, y_pred)
    total = tp + fp + fn + tn
    acc = (tp + tn) / total if total else 0.0
    prec = tp / (tp + fp) if (tp + fp) else 0.0
    rec = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
    return {"acc": acc, "precision": prec, "recall": rec, "f1": f1,
            "tp": tp, "fp": fp, "fn": fn, "tn": tn}


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """PR-AUC as sklearn's ``average_precision_score`` computes it:
    AP = sum_n (R_n - R_{n-1}) * P_n over descending-score thresholds.
    """
    y_true = np.asarray(y_true).astype(np.int64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(y_true.sum())
    if n_pos == 0:
        return 0.0
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order]
    s = y_score[order]
    # group ties: thresholds at distinct score values
    distinct = np.where(np.diff(s))[0]
    idx = np.r_[distinct, y.size - 1]
    tps = np.cumsum(y)[idx].astype(np.float64)
    fps = (idx + 1).astype(np.float64) - tps
    precision = tps / (tps + fps)
    recall = tps / n_pos
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC-AUC via the Mann-Whitney U statistic (tie-aware midranks)."""
    y_true = np.asarray(y_true).astype(np.int64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(y_true.size, dtype=np.float64)
    sorted_scores = y_score[order]
    i = 0
    while i < y_true.size:
        j = i
        while j + 1 < y_true.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = float(ranks[y_true == 1].sum())
    return (rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def best_f1(y_true: np.ndarray, y_score: np.ndarray):
    """Search the decision threshold maximizing F1 (reference: mvuld/ml.py best_f1).

    Returns (best_f1, best_threshold). Candidate thresholds are the distinct
    scores; prediction rule is score > threshold at each candidate's midpoint
    — equivalently we sweep ``score >= t`` over distinct values.
    """
    y_true = np.asarray(y_true).astype(np.int64)
    y_score = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order]
    s = y_score[order]
    n_pos = int(y.sum())
    if n_pos == 0:
        return 0.0, 0.5
    tps = np.cumsum(y).astype(np.float64)
    k = np.arange(1, y.size + 1, dtype=np.float64)
    precision = tps / k
    recall = tps / n_pos
    with np.errstate(invalid="ignore", divide="ignore"):
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)
    # only cut points at the last element of each tie group are realizable
    valid = np.r_[np.diff(s) != 0, True]
    f1 = np.where(valid, f1, -1.0)
    best = int(np.argmax(f1))
    return float(f1[best]), float(s[best])


def get_metrics_logits(y_true: np.ndarray, logits: np.ndarray) -> Dict[str, float]:
    """Full metric dict from 2-class logits (reference: mvuld/ml.py:21-89).

    Hard metrics use P(vul) > 0.5; threshold-free metrics use P(vul) directly.
    """
    prob = softmax(np.asarray(logits, dtype=np.float64), axis=-1)[:, 1]
    return get_metrics_probs(y_true, prob)


def get_metrics_probs(y_true: np.ndarray, prob_vul: np.ndarray) -> Dict[str, float]:
    y_true = np.asarray(y_true).astype(np.int64)
    prob_vul = np.asarray(prob_vul, dtype=np.float64)
    pred = (prob_vul > 0.5).astype(np.int64)
    out = get_metrics(y_true, pred)
    out["pr_auc"] = average_precision(y_true, prob_vul)
    out["roc_auc"] = roc_auc(y_true, prob_vul)
    bf1, bth = best_f1(y_true, prob_vul)
    out["best_f1"] = bf1
    out["best_f1_threshold"] = bth
    return out


def format_metrics(m: Dict[str, float]) -> str:
    keys = ["acc", "precision", "recall", "f1", "pr_auc", "roc_auc", "best_f1"]
    return " | ".join(f"{k}={m[k]:.4f}" for k in keys if k in m)
