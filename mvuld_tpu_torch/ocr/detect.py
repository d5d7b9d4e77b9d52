"""EAST detection post-processing: decode, locality-aware NMS, box→lineno map.

Counterpart of ``mvuld_tpu/ocr/detect.py`` (reference OCR/detect.py:16-378):
threshold the score map (>0.9), restore rotated rectangles from per-pixel
distances and angle, locality-aware NMS (C++ ``native/lanms.cpp`` through
``ocr/lanms_native.py``, with a numpy fallback), then per-box line-number
recognition (``ocr/recognize.py``), producing ``{out_dir}/{id}.pkl``
({lineno: [sx, sy, ex, ey] normalized}; reference detect_dataset_map:285-353).

The numpy half (``restore_polys`` … ``adjust_ratio``) needs no cv2:
``_poly_iou`` intersects the two quads' minimum-area rectangles
(``gt.min_area_rect``) as convex polygons (Sutherland–Hodgman) where the
JAX version calls ``cv2.rotatedRectangleIntersection``.

``detect_image`` is split in two: ``resize_to_32`` (PIL: resize to
multiples of 32) and ``detect_array`` (normalise, pad, run the detector,
decode, drop padded-margin hits, scale back), so the array half runs where
PIL is absent. ``load_east_detector`` returns ``(apply_fn, params)`` with the
JAX contract: ``apply_fn(params, x)`` takes numpy [1, H, W, 3] and returns
numpy channel-last maps (score [1, H/4, W/4, 1], geo [1, H/4, W/4, 5]).
"""

from __future__ import annotations

import glob
import math
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from mvuld_tpu_torch.ocr.gt import min_area_rect


def get_rotate_mat(theta: float) -> np.ndarray:
    return np.array([[np.cos(theta), -np.sin(theta)],
                     [np.sin(theta), np.cos(theta)]], np.float32)


def restore_polys(valid_pos: np.ndarray, valid_geo: np.ndarray,
                  score_shape: Tuple[int, int], scale: int = 4
                  ) -> Tuple[np.ndarray, List[int]]:
    """Rotated-rect restoration (reference: restore_polys:56-91)."""
    polys, index = [], []
    pos = valid_pos * scale
    d = valid_geo[:4]
    angle = valid_geo[4]
    for i in range(pos.shape[0]):
        x, y = float(pos[i, 0]), float(pos[i, 1])
        y_min, y_max = y - d[0, i], y + d[1, i]
        x_min, x_max = x - d[2, i], x + d[3, i]
        rot = get_rotate_mat(-float(angle[i]))
        tx = np.array([x_min, x_max, x_max, x_min]) - x
        ty = np.array([y_min, y_min, y_max, y_max]) - y
        res = rot @ np.stack([tx, ty])
        res[0] += x
        res[1] += y
        # at most one corner may fall outside (reference: is_valid_poly)
        out = ((res[0] < 0) | (res[0] >= score_shape[1] * scale) |
               (res[1] < 0) | (res[1] >= score_shape[0] * scale)).sum()
        if out <= 1:
            index.append(i)
            polys.append(res.T.reshape(-1))
    return (np.asarray(polys, np.float32) if polys else
            np.zeros((0, 8), np.float32)), index


def _poly_area(p: np.ndarray) -> float:
    x, y = p[0::2], p[1::2]
    return 0.5 * abs(float(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1))))


def _rect_corners(quad: np.ndarray) -> np.ndarray:
    """The four corners [4, 2] of ``quad``'s minimum-area rectangle, in
    counter-clockwise order (x right, y up)."""
    cx, cy, long_, short, theta = min_area_rect(quad.reshape(4, 2))
    u = np.array([math.cos(theta), -math.sin(theta)]) * long_ / 2
    v = np.array([math.sin(theta), math.cos(theta)]) * short / 2
    c = np.array([cx, cy])
    return np.stack([c - u - v, c + u - v, c + u + v, c - u + v])


def _clip(subject: List[np.ndarray], a: np.ndarray, b: np.ndarray
          ) -> List[np.ndarray]:
    """Sutherland–Hodgman: ``subject`` clipped to the half-plane left of
    the directed edge a → b."""
    def side(p):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
    out = []
    for i, cur in enumerate(subject):
        prev = subject[i - 1]
        sc, sp = side(cur), side(prev)
        if sc >= 0:
            if sp < 0:
                out.append(prev + (cur - prev) * (sp / (sp - sc)))
            out.append(cur)
        elif sp >= 0:
            out.append(prev + (cur - prev) * (sp / (sp - sc)))
    return out


def _poly_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two quads: the intersection of their minimum-area rectangles
    over the union of the quads' own areas (the JAX version's definition).
    A quad far from a rectangle can have two bounding rectangles of equal
    area up to float32 rounding; cv2 may then take the other one."""
    ra = _rect_corners(np.asarray(a, np.float32))
    rb = _rect_corners(np.asarray(b, np.float32))
    inter_poly = list(ra)
    for i in range(4):
        if not inter_poly:
            break
        inter_poly = _clip(inter_poly, rb[i], rb[(i + 1) % 4])
    if len(inter_poly) < 3:
        return 0.0
    inter = _poly_area(np.asarray(inter_poly).reshape(-1))
    union = _poly_area(a) + _poly_area(b) - inter
    return float(inter / union) if union > 0 else 0.0


def _weighted_merge(g: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Score-weighted vertex merge (lanms semantics)."""
    out = np.empty(9, np.float32)
    out[:8] = (g[8] * g[:8] + p[8] * p[:8]) / (g[8] + p[8])
    out[8] = g[8] + p[8]
    return out


def _standard_nms(polys: np.ndarray, thresh: float) -> np.ndarray:
    order = np.argsort(-polys[:, 8])
    keep = []
    suppressed = np.zeros(len(polys), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        for j in order:
            if j == i or suppressed[j]:
                continue
            if _poly_iou(polys[i, :8], polys[j, :8]) > thresh:
                suppressed[j] = True
    return polys[keep]


_NATIVE = None


def _native_lanms():
    """The C++ NMS (``ocr/lanms_native.py``) built and loaded, or None.
    As in the JAX package, any failure (no compiler, say) falls back to the
    numpy NMS; ``nms_backend()`` says which one runs."""
    global _NATIVE
    if _NATIVE is None:
        try:
            from mvuld_tpu_torch.ocr import lanms_native
            lanms_native.load()
            _NATIVE = lanms_native
        except Exception:
            _NATIVE = False
    return _NATIVE or None


def nms_backend() -> str:
    """"native" when ``nms_locality`` runs native/lanms.cpp, else "numpy"."""
    return "native" if _native_lanms() is not None else "numpy"


def nms_locality_numpy(polys: np.ndarray, thresh: float = 0.2) -> np.ndarray:
    """Locality-aware NMS in numpy: merge consecutive (row-ordered)
    overlapping boxes by score-weighted average, then standard NMS
    (reference: evaluate/test_lnms.py:46, used at detect.py:122)."""
    if len(polys) == 0:
        return polys
    merged = []
    prev: Optional[np.ndarray] = None
    for g in polys:
        if prev is not None and _poly_iou(g[:8], prev[:8]) > thresh:
            prev = _weighted_merge(g, prev)
        else:
            if prev is not None:
                merged.append(prev)
            prev = g.copy()
    if prev is not None:
        merged.append(prev)
    return _standard_nms(np.asarray(merged, np.float32), thresh)


def nms_locality(polys: np.ndarray, thresh: float = 0.2) -> np.ndarray:
    """The native NMS when it builds, else ``nms_locality_numpy``."""
    if len(polys) == 0:
        return polys
    native = _native_lanms()
    if native is not None:
        return native.merge_quadrangle_n9(polys.astype(np.float32), thresh)
    return nms_locality_numpy(polys, thresh)


def get_boxes(score: np.ndarray, geo: np.ndarray, score_thresh: float = 0.9,
              nms_thresh: float = 0.2) -> Optional[np.ndarray]:
    """score [h,w] / geo [h,w,5] (channel-last) → [n, 9] boxes+score
    (reference: get_boxes:94-123)."""
    score = np.squeeze(score)
    xy = np.argwhere(score > score_thresh)          # [n, 2] (row, col)
    if xy.size == 0:
        return None
    xy = xy[np.argsort(xy[:, 0])]                   # row order (locality)
    valid_pos = xy[:, ::-1].astype(np.float32).copy()   # (x, y)
    valid_geo = geo[xy[:, 0], xy[:, 1]].T           # [5, n]
    polys, index = restore_polys(valid_pos, valid_geo, score.shape)
    if polys.shape[0] == 0:
        return None
    boxes = np.zeros((polys.shape[0], 9), np.float32)
    boxes[:, :8] = polys
    boxes[:, 8] = score[xy[index, 0], xy[index, 1]]
    return nms_locality(boxes, nms_thresh)


def adjust_ratio(boxes: Optional[np.ndarray], ratio_w: float, ratio_h: float
                 ) -> Optional[np.ndarray]:
    if boxes is None or boxes.size == 0:
        return None
    boxes[:, 0:8:2] /= ratio_w
    boxes[:, 1:8:2] /= ratio_h
    return boxes


def resize_to_32(img) -> np.ndarray:
    """A PIL image resized to multiples of 32 (at least 32; reference
    resize_img:16-29) as float32 [rh, rw, 3] in [0, 1]."""
    w, h = img.size
    rw = w if w % 32 == 0 else (w // 32) * 32
    rh = h if h % 32 == 0 else (h // 32) * 32
    rw, rh = max(rw, 32), max(rh, 32)
    return np.asarray(img.resize((rw, rh)), np.float32) / 255.0


def detect_array(apply_fn, params, x: np.ndarray, size: Tuple[int, int],
                 score_thresh: float = 0.9, pad_to: int = 0
                 ) -> Optional[np.ndarray]:
    """The detector on one resized image ``x`` [rh, rw, 3] in [0, 1] whose
    original size is ``size`` = (w, h): normalise, pad, run, decode, drop
    padded-margin hits, scale back to the original pixels.

    ``pad_to > 0`` pads bottom/right with white to the next multiple of
    ``pad_to`` (a handful of input shapes over a corpus). EAST is fully
    convolutional: background padding only adds empty score-map area."""
    w, h = size
    rh, rw = x.shape[:2]
    x = (x - 0.5) / 0.5                              # reference load_pil norm
    if pad_to:
        ph = -rh % pad_to
        pw = -rw % pad_to
        if ph or pw:
            # renderer canvases are white; +1.0 is white after the ±0.5 norm
            x = np.pad(x, ((0, ph), (0, pw), (0, 0)), constant_values=1.0)
    score, geo = apply_fn(params, x[None])
    boxes = get_boxes(np.asarray(score)[0, :, :, 0], np.asarray(geo)[0],
                      score_thresh)
    if pad_to and boxes is not None and boxes.size:
        # drop detections that fell entirely in the padding margin
        keep = ((boxes[:, 0:8:2].min(axis=1) < rw) &
                (boxes[:, 1:8:2].min(axis=1) < rh))
        boxes = boxes[keep] if keep.any() else None
    return adjust_ratio(boxes, rw / w, rh / h)


def detect_image(apply_fn, params, img, score_thresh: float = 0.9,
                 pad_to: int = 0) -> Optional[np.ndarray]:
    """Run the detector on one PIL image (``resize_to_32`` then
    ``detect_array``)."""
    return detect_array(apply_fn, params, resize_to_32(img), img.size,
                        score_thresh, pad_to)


def detect_dataset_map(apply_fn, params, img_paths: List[str], out_dir: str,
                       recognizer=None, score_thresh: float = 0.9,
                       logger=None, pad_to: int = 0) -> Dict[str, str]:
    """Detect every image, recognize each box's line number, and write
    ``{out_dir}/{img_id}.pkl`` norm-pos dicts (reference:
    detect_dataset_map:285-353). Needs PIL (and the reader's fonts)."""
    from PIL import Image

    from mvuld_tpu_torch.ocr.recognize import LinenoReader

    recognizer = recognizer or LinenoReader()
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for path in img_paths:
        img_id = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(out_dir, f"{img_id}.pkl")
        if os.path.exists(out_path):
            written[img_id] = out_path
            continue
        img = Image.open(path).convert("RGB")
        W, H = img.size
        boxes = detect_image(apply_fn, params, img, score_thresh,
                             pad_to=pad_to)
        pos: Dict[int, List[float]] = {}
        if boxes is not None:
            for b in boxes:
                xs, ys = b[0:8:2], b[1:8:2]
                x0, x1 = float(xs.min()), float(xs.max())
                y0, y1 = float(ys.min()), float(ys.max())
                pad = 2
                crop = img.crop((max(x0 - pad, 0), max(y0 - pad, 0),
                                 min(x1 + pad, W), min(y1 + pad, H)))
                lineno = recognizer.read(crop)
                if lineno is not None:
                    pos[lineno] = [x0 / W, y0 / H, x1 / W, y1 / H]
        with open(out_path, "wb") as f:
            pickle.dump(pos, f)
        written[img_id] = out_path
        if logger:
            logger.info(f"{img_id}: {len(pos)} node boxes")
    return written


def east_apply_fn(device):
    """``apply_fn(model, x)``: numpy [B, H, W, 3] → numpy channel-last
    (score, geo) of an eval forward of ``model`` on ``device``."""
    import torch

    def apply_fn(model, x):
        with torch.inference_mode():
            xt = torch.as_tensor(np.asarray(x, np.float32)).to(device)
            score, geo = model(xt.permute(0, 3, 1, 2), train=False)
            return (score.permute(0, 2, 3, 1).float().cpu().numpy(),
                    geo.permute(0, 2, 3, 1).float().cpu().numpy())
    return apply_fn


def resolve_east_checkpoint(path: str) -> str:
    """A checkpoint file from ``path``: itself, or the newest
    ``ckpt_epoch_*`` (by epoch number) under a ``train_east --out-dir``
    root (the reference loads a fixed epoch pth, OCR/eval.py:11-49)."""
    if os.path.isdir(path) and not os.path.basename(path).startswith(
            ("ckpt_epoch_", "best_f1_epoch_")):
        cands = [p for p in glob.glob(os.path.join(path, "**", "ckpt_epoch_*"),
                                      recursive=True)
                 if p.rsplit("_", 1)[1].isdigit()]
        if not cands:
            raise FileNotFoundError(f"no ckpt_epoch_* under {path}")
        path = max(cands, key=lambda p: int(p.rsplit("_", 1)[1]))
    return path


def load_east_detector(ckpt_path: str, device="cuda"):
    """Load a trained EAST detector and return ``(apply_fn, params)`` for
    ``detect_image`` / ``detect_dataset_map``: ``params`` is the model in
    eval mode on ``device`` (the card unless the caller asks for the CPU).

    ``ckpt_path``: a port checkpoint (``train_east``'s
    ``checkpoints/ckpt_epoch_{n}``), a ``train_east --out-dir`` root (the
    newest epoch picked), or an ``.npz`` of a JAX run's variables flattened
    with '/' keys (``params/…``, ``batch_stats/…``; README)."""
    from mvuld_tpu_torch.core.checkpoint import load_checkpoint
    from mvuld_tpu_torch.models.convert import jax_variables_to_torch
    from mvuld_tpu_torch.ocr.east import EAST
    from mvuld_tpu_torch.train.predict import resolve_device

    device = resolve_device(str(device))
    model = EAST()
    path = resolve_east_checkpoint(ckpt_path)
    if path.endswith(".npz"):
        with np.load(path) as flat:
            jax_variables_to_torch(dict(flat), model)
    else:
        model.load_state_dict(load_checkpoint(path)["params"])
    model.to(device).eval()
    return east_apply_fn(device), model
