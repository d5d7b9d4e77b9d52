"""EAST ground-truth rasterization (score/geo maps from quad annotations).

Counterpart of ``mvuld_tpu/ocr/gt.py`` (reference OCR/dataset.py
get_score_geo:319 + extract_vertices:375): shrunk polygons mark positive
score pixels; each positive pixel stores its four rotated-rect edge
distances and the rect angle.

``rasterize_gt`` runs in every ``train_east`` step, on the GPU machine too,
which has no cv2: the two cv2 calls of the JAX version are numpy here.

  * ``fill_poly`` is ``cv2.fillPoly`` of one polygon with integer vertices:
    every pixel whose centre lies inside the polygon or on its boundary
    (inclusive of the vertices: the rectangle with corners (2, 3) and
    (6, 5) fills columns 2..6 of rows 3..5). On an axis-aligned rectangle
    the two are the same set; on a rotated one cv2's edge rasterizer also
    takes some pixels whose centres lie just outside, so the two differ
    only on pixels the polygon's edges pass through.
  * ``min_area_rect`` is ``cv2.minAreaRect`` followed by the JAX version's
    normalisation (long side first, angle in [-π/2, π/2], counter-clockwise
    positive), returned directly: (cx, cy, long, short, θ). θ is 0 for a
    wide axis-aligned box and +π/2 for a tall or square one, which is
    what the normalisation makes of cv2 5's −90° for every axis-aligned box.
    Of the rectangles over the hull's edges it takes the first of least
    area; a quad with two of equal area up to float32 rounding (far from
    a rectangle) may get the other one than cv2's.
    Centre and sides are cast to float32 as cv2 returns them; cv2 rounds
    its own float32 arithmetic on the way, so they can differ from cv2's
    in the last bit, and a geo distance by one float32 rounding.

``crop_with_text`` keeps PIL (imported inside) and the JAX version's draws.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

SHRINK = 0.3
SCALE = 4            # gt maps are at 1/4 input resolution


def parse_icdar_line(line: str) -> Tuple[np.ndarray, str]:
    parts = line.strip().split(",")
    quad = np.asarray([float(p) for p in parts[:8]], np.float32).reshape(4, 2)
    label = ",".join(parts[8:])
    return quad, label


def shrink_quad(quad: np.ndarray, coef: float = SHRINK) -> np.ndarray:
    """Move each vertex toward the centroid by coef·(short side) — the EAST
    shrink that keeps score pixels off the boundary."""
    ctr = quad.mean(axis=0, keepdims=True)
    return quad + (ctr - quad) * coef


def fill_poly(mask: np.ndarray, verts: np.ndarray, value: int = 1) -> None:
    """Set ``mask`` to ``value`` on every pixel whose centre (x, y) lies
    inside the polygon ``verts`` [n, 2] (integer x, y) or on its boundary;
    the polygon is clipped to the mask. Exact integer arithmetic."""
    h, w = mask.shape
    v = np.asarray(verts, np.int64).reshape(-1, 2)
    x0, x1 = max(int(v[:, 0].min()), 0), min(int(v[:, 0].max()), w - 1)
    y0, y1 = max(int(v[:, 1].min()), 0), min(int(v[:, 1].max()), h - 1)
    if x0 > x1 or y0 > y1:
        return
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    inside = np.zeros(xs.shape, bool)
    on_edge = np.zeros(xs.shape, bool)
    for (ax, ay), (bx, by) in zip(v, np.roll(v, -1, axis=0)):
        cross = (bx - ax) * (ys - ay) - (by - ay) * (xs - ax)
        on_edge |= ((cross == 0) & (xs >= min(ax, bx)) & (xs <= max(ax, bx))
                    & (ys >= min(ay, by)) & (ys <= max(ay, by)))
        if ay != by:
            # crossing number: the edge crosses the pixel's row to its right
            straddles = (ay > ys) != (by > ys)
            inside ^= straddles & ((cross > 0) if by > ay else (cross < 0))
    mask[y0:y1 + 1, x0:x1 + 1][inside | on_edge] = value


def _convex_hull(p: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull of [n, 2] float64 points (collinear points
    dropped), counter-clockwise in x-right / y-up axes."""
    pts = sorted(set(map(tuple, p.tolist())))
    if len(pts) <= 2:
        return np.asarray(pts, np.float64).reshape(-1, 2)

    def half(seq):
        out: List[tuple] = []
        for q in seq:
            while len(out) >= 2 and ((out[-1][0] - out[-2][0]) * (q[1] - out[-2][1])
                                     - (out[-1][1] - out[-2][1]) * (q[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(q)
        return out[:-1]
    return np.asarray(half(pts) + half(pts[::-1]), np.float64)


def min_area_rect(points: np.ndarray) -> Tuple[float, float, float, float,
                                                  float]:
    """(cx, cy, long side, short side, θ) of the smallest rectangle holding
    ``points`` [n, 2] (pixel coordinates, y down), θ the long side's angle
    counter-clockwise in [-π/2, π/2] — cv2.minAreaRect as the JAX
    ``rasterize_gt`` normalises it. Python floats, as cv2 returns them."""
    p = np.asarray(points, np.float32).reshape(-1, 2).astype(np.float64)
    hull = _convex_hull(p)
    if len(hull) == 1:
        return float(hull[0, 0]), float(hull[0, 1]), 0.0, 0.0, 0.0
    best = None
    for i in range(len(hull) if len(hull) > 2 else 1):
        e = hull[(i + 1) % len(hull)] - hull[i]
        u = e / math.hypot(e[0], e[1])
        v = np.array([-u[1], u[0]])
        a, b = hull @ u, hull @ v
        area = (a.max() - a.min()) * (b.max() - b.min())
        if best is None or area < best[0]:
            best = (area, u, v, a, b)
    _, u, v, a, b = best
    ctr = u * (a.max() + a.min()) / 2 + v * (b.max() + b.min()) / 2
    la, lb = a.max() - a.min(), b.max() - b.min()
    # the long side; between equal sides the steeper one (cv2 5 gives every
    # axis-aligned box −90°, which the normalisation makes θ = π/2 when the
    # sides are equal)
    if la > lb or (la == lb and abs(u[1]) > abs(v[1])):
        long_dir, long_, short = u, la, lb
    else:
        long_dir, long_, short = v, lb, la
    if long_dir[0] < 0 or (long_dir[0] == 0 and long_dir[1] > 0):
        long_dir = -long_dir
    theta = math.atan2(-long_dir[1], long_dir[0]) + 0.0
    f32 = lambda t: float(np.float32(t))  # noqa: E731
    return f32(ctr[0]), f32(ctr[1]), f32(long_), f32(short), theta


def rasterize_gt(quads: Sequence[np.ndarray], img_h: int, img_w: int,
                 ignored: Sequence[bool] | None = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (score [h,w,1], geo [h,w,5], ignored_map [h,w,1]) at 1/4 scale."""
    h, w = img_h // SCALE, img_w // SCALE
    score = np.zeros((h, w, 1), np.float32)
    geo = np.zeros((h, w, 5), np.float32)
    ignored_map = np.zeros((h, w, 1), np.float32)
    if ignored is None:
        ignored = [False] * len(quads)

    ys, xs = np.mgrid[0:h, 0:w]
    px = xs.astype(np.float32) * SCALE    # full-scale pixel coordinates
    py = ys.astype(np.float32) * SCALE

    for quad, ign in zip(quads, ignored):
        quad = np.asarray(quad, np.float32).reshape(4, 2)
        shrunk = shrink_quad(quad)
        mask = np.zeros((h, w), np.uint8)
        fill_poly(mask, np.round(shrunk / SCALE).astype(np.int32))
        if ign:
            ignored_map[mask > 0, 0] = 1.0
            continue
        cx, cy, rw, rh, theta = min_area_rect(quad)
        # the JAX version's types: Python-float centre and sides, a numpy
        # float64 angle (it comes from np.deg2rad there)
        theta = np.float64(theta)
        cos, sin = np.cos(theta), np.sin(theta)
        # rotate pixels into the rect frame
        rx = (px - cx) * cos - (py - cy) * sin
        ry = (px - cx) * sin + (py - cy) * cos
        d_top = rh / 2 + ry                # distance to top edge
        d_bot = rh / 2 - ry
        d_left = rw / 2 + rx
        d_right = rw / 2 - rx
        m = mask > 0
        score[m, 0] = 1.0
        geo[m, 0] = np.maximum(d_top[m], 0)
        geo[m, 1] = np.maximum(d_bot[m], 0)
        geo[m, 2] = np.maximum(d_left[m], 0)
        geo[m, 3] = np.maximum(d_right[m], 0)
        geo[m, 4] = theta
    return score, geo, ignored_map


def crop_with_text(img, quads: np.ndarray, length: int,
                   rng: np.random.RandomState):
    """Text-region-aware random square crop — the reference's active EAST
    training augmentation (OCR/dataset.py crop_img:197-248).

    (1) bilinear-upscale so the short side ≥ ``length`` (quads scaled
    along); (2) choose the crop origin uniformly from the range that keeps
    the full text extent inside the window when it fits; (3) shift quads
    into crop coordinates. img: PIL Image; quads: [n, 4, 2] float pixels.
    Returns (PIL length² crop, shifted quads [n, 4, 2]); two draws from
    ``rng``, as in the JAX version.
    """
    from PIL import Image

    w, h = img.size
    if h >= w and w < length:
        img = img.resize((length, int(h * length / w)), Image.BILINEAR)
    elif h < w and h < length:
        img = img.resize((int(w * length / h), length), Image.BILINEAR)
    ratio_w = img.width / w
    ratio_h = img.height / h
    quads = np.asarray(quads, np.float32).reshape(-1, 4, 2).copy()
    quads[..., 0] *= ratio_w
    quads[..., 1] *= ratio_h

    remain_w = [0, img.width - length]
    remain_h = [0, img.height - length]
    if quads.size:
        x_lo, x_hi = quads[..., 0].min(), quads[..., 0].max()
        y_lo, y_hi = quads[..., 1].min(), quads[..., 1].max()
        if x_hi > length:
            remain_w[0] = x_hi - length
        if x_lo < remain_w[1]:
            remain_w[1] = x_lo
        if y_hi > length:
            remain_h[0] = y_hi - length
        if y_lo < remain_h[1]:
            remain_h[1] = y_lo
    start_w = int(rng.rand() * (remain_w[1] - remain_w[0])) + int(remain_w[0])
    start_h = int(rng.rand() * (remain_h[1] - remain_h[0])) + int(remain_h[0])
    region = img.crop((start_w, start_h, start_w + length, start_h + length))
    if quads.size:
        quads[..., 0] -= start_w
        quads[..., 1] -= start_h
    return region, quads


def gt_from_icdar(lines: List[str], img_h: int, img_w: int):
    quads, ignored = [], []
    for line in lines:
        quad, label = parse_icdar_line(line)
        quads.append(quad)
        ignored.append(label.strip() == "###")
    return rasterize_gt(quads, img_h, img_w, ignored)
