"""ICDAR-style detection evaluation: IoU-0.5 precision / recall / H-mean.

Counterpart of ``mvuld_tpu/ocr/icdar_eval.py`` on the port's cv2-free
``detect._poly_iou``. The reference ships the RRC evaluation scripts (reference: OCR/evaluate/
script.py:16-40, rrc_evaluation_funcs.py) as the detector's acceptance
metric. This is the same protocol without shapely: one-to-one greedy
matching of detections to ground-truth quads at IoU ≥ 0.5, '###' gt marked
don't-care (detections matching don't-care are discarded).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from mvuld_tpu_torch.ocr.detect import _poly_iou


def evaluate_detections(gt_quads: Sequence[np.ndarray],
                        gt_ignored: Sequence[bool],
                        det_quads: Sequence[np.ndarray],
                        iou_thresh: float = 0.5) -> Dict[str, float]:
    """One image. quads are [8] float arrays (x1..y4)."""
    gt_quads = [np.asarray(q, np.float32).reshape(-1) for q in gt_quads]
    det_quads = [np.asarray(q, np.float32).reshape(-1)[:8] for q in det_quads]

    care_idx = [i for i, ign in enumerate(gt_ignored) if not ign]
    dontcare_idx = [i for i, ign in enumerate(gt_ignored) if ign]

    # drop detections that mostly overlap don't-care regions
    kept_dets = []
    for d in det_quads:
        if any(_poly_iou(d, gt_quads[i]) > 0.5 for i in dontcare_idx):
            continue
        kept_dets.append(d)

    matched_gt = set()
    matched_det = set()
    for di, d in enumerate(kept_dets):
        best, best_iou = None, iou_thresh
        for gi in care_idx:
            if gi in matched_gt:
                continue
            iou = _poly_iou(d, gt_quads[gi])
            if iou >= best_iou:
                best, best_iou = gi, iou
        if best is not None:
            matched_gt.add(best)
            matched_det.add(di)

    n_gt = len(care_idx)
    n_det = len(kept_dets)
    tp = len(matched_det)
    precision = tp / n_det if n_det else (1.0 if n_gt == 0 else 0.0)
    recall = tp / n_gt if n_gt else 1.0
    hmean = (2 * precision * recall / (precision + recall)
             if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "hmean": hmean,
            "gt_care": n_gt, "det": n_det, "matched": tp}


def evaluate_dataset(per_image: List[Dict[str, float]]) -> Dict[str, float]:
    """Micro-averaged dataset metrics over per-image results."""
    tp = sum(m["matched"] for m in per_image)
    n_gt = sum(m["gt_care"] for m in per_image)
    n_det = sum(m["det"] for m in per_image)
    precision = tp / n_det if n_det else (1.0 if n_gt == 0 else 0.0)
    recall = tp / n_gt if n_gt else 1.0
    hmean = (2 * precision * recall / (precision + recall)
             if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "hmean": hmean}
