"""The port's OCR subsystem (``mvuld_tpu_torch/ocr``) against the JAX
package's, on the CPU, on inputs made from numpy seeds.

- ``gt``: ``fill_poly`` is ``cv2.fillPoly`` on integer rectangles (every
  pixel equal). ``rasterize_gt`` against the JAX (cv2) version: on the
  renderer's axis-aligned boxes of a few synthetic functions (and on
  seeded axis-aligned boxes, partly off the canvas) the score and ignored
  maps and the angle channel are equal and each distance is within 1e-4 px
  (cv2 rounds the rectangle's centre and sides through its own float32
  arithmetic: one float32 rounding of a value below 512 is at most 3.1e-5);
  on seeded rotated quads the score maps differ only on pixels whose
  centre lies within √2/2 px of the rounded polygon's edges (the edge
  passes through the pixel: cv2's edge rasterizer), the distances agree
  within 1e-4 px and the angle within 1e-6 rad where both are positive.
  ``crop_with_text`` gives JAX's crop with the same ``RandomState``, pixel
  for pixel and quad for quad; ``gt_from_icdar`` with a ``###`` line gives
  JAX's maps.
- ``detect``'s numpy half: ``restore_polys``, ``get_boxes`` and
  ``adjust_ratio`` equal to JAX's; ``_poly_iou`` (numpy) within 1e-5 of
  JAX's cv2 version on seeded disjoint, nested, crossing and rotated pairs;
  (quads near rectangles: a quad distorted far from one can have two
  bounding rectangles of equal area up to float32 rounding, which cv2 and
  the numpy version may resolve either way);
  ``nms_locality`` gives JAX's boxes on the numpy path and on the native
  path (the same ``native/lanms.cpp``, built into the port's directory);
  ``detect_image`` with ``pad_to`` and the split ``detect_array``.
- ``icdar_eval.evaluate_detections`` / ``evaluate_dataset`` equal JAX's.
- ``recognize``: ``GlyphRecognizer.recognize``, ``LinenoReader.read`` and
  ``lineno_from_text`` give JAX's readings on the renderer's labels, in the
  default and the held-out style.
- ``detect_dataset_map`` with the oracle detector of
  ``tests/test_train_east.py`` writes JAX's pickles.
"""

import math
import os
import pickle

import numpy as np
import pytest

GEO_ATOL = 1e-4          # px: one float32 rounding of cv2's rectangle
THETA_ATOL = 1e-6        # rad, rotated quads


def _rendered(n, seed, style=None):
    """[(image, {lineno: box px})] of the JAX renderer's output."""
    from mvuld_tpu.tools.cpg import extract_line_cpg
    from mvuld_tpu.tools.render import DEFAULT_STYLE, layout, render_cpg
    from mvuld_tpu.tools.synthetic import generate_dataset
    style = style or DEFAULT_STYLE
    out = []
    for _, row in generate_dataset(n, seed=seed).iterrows():
        cpg = extract_line_cpg(row.func_before)
        if cpg is None:
            continue
        g = cpg.filtered("all")
        if len(g.nodes) < 2:
            continue
        img, _ = render_cpg(g, out_path=None, style=style)
        out.append((img, layout(g, style)))
    return out


@pytest.fixture(scope="module")
def renders():
    return _rendered(4, seed=3)


def _box_quad(x0, y0, x1, y1):
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)


def _assert_gt_equal(got, want):
    (gs, gg, gi), (ws, wg, wi) = got, want
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gg[..., 4], wg[..., 4])
    np.testing.assert_allclose(gg[..., :4], wg[..., :4], rtol=0,
                               atol=GEO_ATOL)


# ------------------------------------------------------------------- gt

def test_fill_poly_is_cv2_fill_poly_on_rectangles():
    import cv2

    from mvuld_tpu_torch.ocr.gt import fill_poly
    rng = np.random.RandomState(0)
    mine = np.zeros((12, 12), np.uint8)
    fill_poly(mine, _box_quad(2, 3, 6, 5).astype(np.int32))
    assert mine.sum() == 15 and mine[3:6, 2:7].all()
    for _ in range(500):
        x0, y0 = rng.randint(-6, 36, 2)
        x1, y1 = x0 + rng.randint(0, 18), y0 + rng.randint(0, 18)
        v = _box_quad(x0, y0, x1, y1).astype(np.int32)
        want = np.zeros((32, 32), np.uint8)
        cv2.fillPoly(want, [v], 1)
        got = np.zeros((32, 32), np.uint8)
        fill_poly(got, v)
        np.testing.assert_array_equal(got, want, err_msg=str(v.tolist()))


def test_rasterize_gt_matches_jax_on_the_renderers_boxes(renders):
    from mvuld_tpu.ocr.gt import rasterize_gt as jras
    from mvuld_tpu_torch.ocr.gt import rasterize_gt
    assert len(renders) >= 3
    for img, boxes in renders:
        S = 256
        sx, sy = S / img.width, S / img.height
        quads = [_box_quad(x0 * sx, y0 * sy, x1 * sx, y1 * sy)
                 for (x0, y0, x1, y1) in boxes.values()]
        want = jras(quads, S, S)
        assert want[0].sum() > 0
        _assert_gt_equal(rasterize_gt(quads, S, S), want)
        # the native size too (integer boxes)
        q = [_box_quad(*b) for b in boxes.values()]
        H, W = img.height // 4 * 4, img.width // 4 * 4
        _assert_gt_equal(rasterize_gt(q, H, W), jras(q, H, W))


def test_rasterize_gt_matches_jax_on_seeded_axis_aligned_boxes():
    from mvuld_tpu.ocr.gt import rasterize_gt as jras
    from mvuld_tpu_torch.ocr.gt import rasterize_gt
    rng = np.random.RandomState(1)
    for _ in range(60):
        quads = []
        for _ in range(rng.randint(1, 6)):
            x0, y0 = rng.rand(2) * 140 - 10
            w, h = rng.rand(2) * 60 + 1
            quads.append(_box_quad(x0, y0, x0 + w, y0 + h))
        ign = list(rng.rand(len(quads)) < 0.2)
        _assert_gt_equal(rasterize_gt(quads, 128, 128, ign),
                         jras(quads, 128, 128, ign))
    # squares: cv2 gives them −90°, θ = π/2 after the normalisation
    squares = [_box_quad(x, y, x + s, y + s) for x, y, s in
               ((10, 12, 30), (50.5, 60.25, 17.75), (-4, 70, 40))]
    want = jras(squares, 128, 128)
    assert (want[1][..., 4][want[0][..., 0] > 0] == np.float32(np.pi / 2)).all()
    _assert_gt_equal(rasterize_gt(squares, 128, 128), want)


def _seg_dist(px, py, a, b):
    d = b - a
    t = np.clip(((px - a[0]) * d[0] + (py - a[1]) * d[1]) / max(d @ d, 1e-12),
                0, 1)
    return math.hypot(px - a[0] - t * d[0], py - a[1] - t * d[1])


def _rotated_quads(rng, n):
    for _ in range(n):
        c = rng.rand(2) * 140 + 30
        long_ = rng.rand() * 70 + 10
        short = long_ / (rng.rand() * 3 + 1.2)
        th = rng.uniform(-math.pi, math.pi)
        u = np.array([math.cos(th), math.sin(th)])
        v = np.array([-u[1], u[0]])
        q = np.array([c - long_ / 2 * u - short / 2 * v,
                      c + long_ / 2 * u - short / 2 * v,
                      c + long_ / 2 * u + short / 2 * v,
                      c - long_ / 2 * u + short / 2 * v], np.float32)
        yield q[::-1].copy() if rng.rand() < 0.5 else q


def _edge_pixel_diffs(got, want, quads):
    """Pixels where the score maps differ; each must have its centre within
    √2/2 px of an edge of some quad's shrunk, rounded polygon."""
    from mvuld_tpu.ocr.gt import shrink_quad
    polys = [np.round(shrink_quad(np.asarray(q, np.float32)) / 4)
             .astype(np.float64) for q in quads]
    diffs = np.argwhere(got[..., 0] != want[..., 0])
    for i, j in diffs:
        d = min(_seg_dist(j, i, v[k], v[(k + 1) % 4])
                for v in polys for k in range(4))
        assert d <= math.sqrt(2) / 2, (i, j, d)
    return len(diffs)


def _assert_geo_close(got, want):
    both = (got[0][..., 0] > 0) & (want[0][..., 0] > 0)
    assert both.sum() > 0
    np.testing.assert_allclose(got[1][both][:, :4], want[1][both][:, :4],
                               rtol=0, atol=GEO_ATOL)
    np.testing.assert_allclose(got[1][both][:, 4], want[1][both][:, 4],
                               rtol=0, atol=THETA_ATOL)


def test_rasterize_gt_matches_jax_on_rotated_quads_off_the_edges():
    from mvuld_tpu.ocr.gt import rasterize_gt as jras
    from mvuld_tpu_torch.ocr.gt import rasterize_gt
    rng = np.random.RandomState(2)
    edge_diffs = 0
    for q in _rotated_quads(rng, 120):
        got, want = rasterize_gt([q], 256, 256), jras([q], 256, 256)
        edge_diffs += _edge_pixel_diffs(got[0], want[0], [q])
        _assert_geo_close(got, want)
    assert edge_diffs > 0       # the bound is exercised


def test_crop_with_text_matches_jax():
    from PIL import Image

    from mvuld_tpu.ocr.gt import crop_with_text as jcrop
    from mvuld_tpu_torch.ocr.gt import crop_with_text
    rng = np.random.RandomState(3)
    for W, H, L in ((320, 300, 256), (100, 80, 128), (90, 200, 128),
                    (400, 120, 256)):
        img = Image.fromarray(rng.randint(0, 255, (H, W, 3), np.uint8))
        quads = np.stack([_box_quad(x0, y0, x0 + 30, y0 + 12)
                          for x0, y0 in rng.rand(3, 2) * [W - 30, H - 12]])
        seed = rng.randint(1 << 30)
        a, qa = crop_with_text(img, quads, L, np.random.RandomState(seed))
        b, qb = jcrop(img, quads, L, np.random.RandomState(seed))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(qa, qb)


def test_gt_from_icdar_with_an_ignored_line_matches_jax():
    from mvuld_tpu.ocr.gt import gt_from_icdar as jgt
    from mvuld_tpu_torch.ocr.gt import gt_from_icdar, parse_icdar_line
    lines = ["10,10,60,10,60,30,10,30,IF_12: IF (A > 0) {",
             "70,40,120,40,120,60,70,60,###",
             "20,70,100,72,98,92,18,90,LOCAL_3: INT X;"]
    quad, label = parse_icdar_line(lines[0])
    assert label == "IF_12: IF (A > 0) {" and quad.shape == (4, 2)
    got, want = gt_from_icdar(lines, 128, 128), jgt(lines, 128, 128)
    assert want[2].sum() > 0 and want[0].sum() > 0
    np.testing.assert_array_equal(got[2], want[2])      # the ### box
    quads = [parse_icdar_line(ln)[0] for ln in lines]
    _edge_pixel_diffs(got[0], want[0], [quads[0], quads[2]])
    _assert_geo_close(got, want)


# ------------------------------------------------------------ detect

def _planted_maps(h, w, boxes):
    """Score/geo maps with the box pixels of each (r0, r1, c0, c1, y0, y1,
    x0, x1, angle) set, as the JAX tests plant them."""
    score = np.zeros((h, w), np.float32)
    geo = np.zeros((h, w, 5), np.float32)
    for r0, r1, c0, c1, y0, y1, x0, x1, ang in boxes:
        for r in range(r0, r1):
            for c in range(c0, c1):
                score[r, c] = 0.95 + 0.001 * (r + c)
                y, x = r * 4, c * 4
                geo[r, c] = [y - y0, y1 - y, x - x0, x1 - x, ang]
    return score, geo


MAPS = [(10, 14, 13, 19, 40, 56, 48, 80, 0.0),
        (20, 23, 2, 9, 78, 94, 4, 40, 0.05),
        (3, 6, 20, 28, 10, 26, 78, 116, -0.1)]


def test_restore_polys_and_get_boxes_match_jax(monkeypatch):
    from mvuld_tpu.ocr import detect as jd
    from mvuld_tpu_torch.ocr import detect as pd
    rng = np.random.RandomState(4)
    pos = (rng.rand(40, 2) * 32).astype(np.float32)
    geo = np.concatenate([rng.rand(4, 40) * 20,
                          rng.uniform(-0.7, 0.7, (1, 40))]).astype(np.float32)
    a, ia = pd.restore_polys(pos.copy(), geo, (32, 32))
    b, ib = jd.restore_polys(pos.copy(), geo, (32, 32))
    assert ia == ib and 0 < len(ia) < 40
    np.testing.assert_array_equal(a, b)
    score, geo = _planted_maps(32, 32, MAPS)
    for native in (False, None):
        monkeypatch.setattr(jd, "_NATIVE", native)
        monkeypatch.setattr(pd, "_NATIVE", native)
        got, want = pd.get_boxes(score, geo), jd.get_boxes(score, geo)
        assert want is not None and len(want) == 3
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert pd.get_boxes(np.zeros((8, 8)), np.zeros((8, 8, 5))) is None
    boxes = want.copy()
    np.testing.assert_array_equal(pd.adjust_ratio(boxes.copy(), 0.5, 2.0),
                                  jd.adjust_ratio(boxes.copy(), 0.5, 2.0))
    assert pd.adjust_ratio(None, 1, 1) is None
    assert pd.adjust_ratio(np.zeros((0, 9)), 1, 1) is None


def _pairs(rng):
    """Seeded quad pairs: disjoint, nested, crossing, rotated."""
    def rect(cx, cy, w, h, th=0.0):
        u = np.array([math.cos(th), math.sin(th)])
        v = np.array([-u[1], u[0]])
        c = np.array([cx, cy])
        return np.array([c - w / 2 * u - h / 2 * v, c + w / 2 * u - h / 2 * v,
                         c + w / 2 * u + h / 2 * v, c - w / 2 * u + h / 2 * v],
                        np.float32).reshape(-1)
    for _ in range(25):
        cx, cy = rng.rand(2) * 100 + 50
        w, h = rng.rand(2) * 40 + 5
        yield "disjoint", rect(cx, cy, w, h), rect(cx + w + 5, cy, w, h)
        yield "nested", rect(cx, cy, w, h), rect(cx + 1, cy - 0.5, w / 2, h / 2)
        yield ("crossing", rect(cx, cy, w, h),
               rect(cx + w / 3, cy + h / 4, w, h))
        yield ("rotated", rect(cx, cy, w, h, rng.uniform(-1.5, 1.5)),
               rect(cx + rng.randn() * 5, cy + rng.randn() * 5, h + 3, w,
                    rng.uniform(-1.5, 1.5)))


def test_poly_iou_matches_jax_within_1e5():
    from mvuld_tpu.ocr.detect import _poly_iou as jiou
    from mvuld_tpu_torch.ocr.detect import _poly_iou
    seen = set()
    for kind, a, b in _pairs(np.random.RandomState(5)):
        want = jiou(a, b)
        assert abs(_poly_iou(a, b) - want) <= 1e-5, (kind, a, b)
        assert abs(_poly_iou(b, a) - jiou(b, a)) <= 1e-5, (kind, a, b)
        seen.add((kind, want > 0))
    assert {("disjoint", False), ("nested", True), ("crossing", True),
            ("rotated", True)} <= seen


def _nms_boxes(rng, n=30):
    boxes = []
    for _ in range(n):
        x0, y0 = rng.rand(2) * 100
        w, h = rng.rand(2) * 30 + 5
        jitter = rng.randn(8) * 0.5
        q = _box_quad(x0, y0, x0 + w, y0 + h).reshape(-1) + jitter
        boxes.append(np.r_[q, rng.rand()].astype(np.float32))
    return np.stack(boxes)


def test_nms_locality_matches_jax_numpy_and_native(monkeypatch):
    from mvuld_tpu.ocr import detect as jd
    from mvuld_tpu_torch.ocr import detect as pd
    from mvuld_tpu_torch.ocr import lanms_native
    rng = np.random.RandomState(6)
    for _ in range(4):
        boxes = _nms_boxes(rng)
        monkeypatch.setattr(jd, "_NATIVE", False)
        monkeypatch.setattr(pd, "_NATIVE", False)
        assert pd.nms_backend() == "numpy"
        want = jd.nms_locality(boxes.copy(), 0.2)
        np.testing.assert_allclose(pd.nms_locality(boxes.copy(), 0.2), want,
                                   rtol=0, atol=1e-5)
        assert 1 <= len(want) < len(boxes)
        monkeypatch.setattr(jd, "_NATIVE", None)
        monkeypatch.setattr(pd, "_NATIVE", None)
        assert pd.nms_backend() == "native"
        want = jd.nms_locality(boxes.copy(), 0.2)
        np.testing.assert_array_equal(pd.nms_locality(boxes.copy(), 0.2),
                                      want)
    # the port's library, in its own build directory
    so = lanms_native.library_path()
    assert os.path.exists(so)
    assert os.sep.join(["build", "mvuld_tpu_torch"]) in so
    assert pd.nms_locality(np.zeros((0, 9), np.float32)).shape == (0, 9)


def test_native_nms_falls_back_to_numpy_without_a_compiler(monkeypatch):
    from mvuld_tpu_torch.ocr import detect as pd
    from mvuld_tpu_torch.ocr import lanms_native

    def no_compiler():
        raise FileNotFoundError("g++")
    monkeypatch.setattr(pd, "_NATIVE", None)
    monkeypatch.setattr(lanms_native, "load", no_compiler)
    assert pd.nms_backend() == "numpy"
    boxes = _nms_boxes(np.random.RandomState(7), 10)
    np.testing.assert_array_equal(pd.nms_locality(boxes.copy()),
                                  pd.nms_locality_numpy(boxes.copy()))


def _planted_apply(_params, x):
    h, w = x.shape[1] // 4, x.shape[2] // 4
    score, geo = _planted_maps(h, w, MAPS[:1])
    return score[None, :, :, None], geo[None]


def test_detect_image_pad_to_and_detect_array_match_jax():
    from PIL import Image

    from mvuld_tpu.ocr.detect import detect_image as jdetect
    from mvuld_tpu_torch.ocr.detect import (detect_array, detect_image,
                                            resize_to_32)
    for W, H in ((160, 128), (173, 141), (300, 200)):
        img = Image.new("RGB", (W, H), "white")
        for pad in (0, 256):
            got = detect_image(_planted_apply, None, img, pad_to=pad)
            want = jdetect(_planted_apply, None, img, pad_to=pad)
            if want is None:
                assert got is None
                continue
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            x = resize_to_32(img)
            assert x.shape[0] % 32 == 0 and x.shape[1] % 32 == 0
            np.testing.assert_array_equal(
                detect_array(_planted_apply, None, x, img.size, pad_to=pad),
                got)


# --------------------------------------------------------- icdar_eval

def test_evaluate_detections_and_dataset_match_jax():
    from mvuld_tpu.ocr import icdar_eval as je
    from mvuld_tpu_torch.ocr import icdar_eval as pe
    rng = np.random.RandomState(8)
    per_j, per_p = [], []
    for _ in range(6):
        gts = [_box_quad(*(rng.rand(2) * 100), *(rng.rand(2) * 100 + 110))
               for _ in range(rng.randint(1, 5))]
        ign = list(rng.rand(len(gts)) < 0.3)
        # detections: the gt boxes moved by up to a few px per corner. (A
        # quad distorted far from a rectangle can have two bounding
        # rectangles of equal area up to float32 rounding; cv2 and the
        # numpy version may then take different ones.)
        dets = [g + rng.randn(4, 2).astype(np.float32) * rng.choice([1, 6])
                for g in gts if rng.rand() < 0.8]
        dets += [_box_quad(300, 300, 340, 320)] * rng.randint(0, 2)
        want = je.evaluate_detections(gts, ign, dets)
        got = pe.evaluate_detections(gts, ign, dets)
        assert got == want
        per_j.append(want)
        per_p.append(got)
    assert pe.evaluate_dataset(per_p) == je.evaluate_dataset(per_j)
    assert 0 < je.evaluate_dataset(per_j)["hmean"] < 1


# ------------------------------------------------------------ recognize

@pytest.fixture(scope="module")
def readers():
    from mvuld_tpu.ocr.recognize import GlyphRecognizer as JG
    from mvuld_tpu.ocr.recognize import LinenoReader as JL
    from mvuld_tpu_torch.ocr.recognize import GlyphRecognizer, LinenoReader
    return (GlyphRecognizer(), LinenoReader()), (JG(), JL())


def _label_crops(renders):
    for img, boxes in renders:
        for ln, (x0, y0, x1, y1) in boxes.items():
            yield ln, img.crop((max(x0 - 2, 0), max(y0 - 2, 0),
                                min(x1 + 2, img.width),
                                min(y1 + 2, img.height)))


def test_recognizer_and_reader_match_jax_default_style(readers, renders):
    from mvuld_tpu.ocr.recognize import lineno_from_text as jparse
    from mvuld_tpu_torch.ocr.recognize import lineno_from_text
    (glyph, reader), (jglyph, jreader) = readers
    n = ok = 0
    for i, (ln, crop) in enumerate(_label_crops(renders)):
        got = reader.read(crop)
        assert got == jreader.read(crop)
        n, ok = n + 1, ok + (got == ln)
        if i % 4 == 0:          # full-text recognition: slower, a sample
            text = glyph.recognize(crop)
            assert text == jglyph.recognize(crop)
            assert lineno_from_text(text) == jparse(text)
    assert n >= 20 and ok / n >= 0.95
    for s in ("IF_12: IF (A > 0) {", "LOCAL_3:INT X;", "garbage",
              "FOR 9 : X", "CALL_l0; F", "x_S7I"):
        assert lineno_from_text(s) == jparse(s)


def test_reader_matches_jax_held_out_style(readers):
    from mvuld_tpu.tools.render import HELD_OUT_STYLE
    (_, reader), (_, jreader) = readers
    crops = list(_label_crops(_rendered(3, seed=123, style=HELD_OUT_STYLE)))
    assert len(crops) >= 10
    for _ln, crop in crops:
        assert reader.read(crop) == jreader.read(crop)


# ------------------------------------------------------ dataset map

def test_detect_dataset_map_with_gt_oracle_matches_jax(tmp_path, readers):
    """The oracle detector of tests/test_train_east.py (the rasterized gt
    of the resized image), through both packages' detect_dataset_map."""
    from mvuld_tpu.ocr.detect import detect_dataset_map as jmap
    from mvuld_tpu.tools.cpg import extract_line_cpg
    from mvuld_tpu.tools.render import layout, render_cpg
    from mvuld_tpu_torch.ocr.detect import detect_dataset_map
    from mvuld_tpu_torch.ocr.gt import rasterize_gt

    code = "int f(int a)\n{\n    int x;\n    x = a;\n    return x;\n}"
    cpg = extract_line_cpg(code).filtered("all")
    img_path = str(tmp_path / "7.png")
    img, gt_pos = render_cpg(cpg, out_path=img_path)
    boxes_px = layout(cpg)

    def oracle_apply(_params, x):
        H, W = int(x.shape[1]), int(x.shape[2])
        sx, sy = W / img.size[0], H / img.size[1]
        quads = [_box_quad(x0 * sx, y0 * sy, x1 * sx, y1 * sy)
                 for (x0, y0, x1, y1) in boxes_px.values()]
        score, geo, _ = rasterize_gt(quads, H, W)
        return score[None], geo[None]

    (_, reader), (_, jreader) = readers
    out = detect_dataset_map(oracle_apply, None, [img_path],
                             str(tmp_path / "pos"), recognizer=reader)
    ref = jmap(oracle_apply, None, [img_path], str(tmp_path / "jpos"),
               recognizer=jreader)
    with open(out["7"], "rb") as f:
        pos = pickle.load(f)
    with open(ref["7"], "rb") as f:
        want = pickle.load(f)
    assert pos == want
    assert len(set(pos) & set(gt_pos)) >= max(len(gt_pos) - 2, 2)


# ------------------------------------------------ the loaders' stand-in

def oracle_detector(img_dir, pos_dir, pad_to=256):
    """A stand-in for both packages' ``load_east_detector``: ``apply_fn``
    finds which PNG under ``img_dir`` its input is (resized to /32,
    normalised and padded as ``detect_image`` does) and returns the
    rasterized maps of that image's renderer boxes (``pos_dir``'s norm-pos
    pickles), a perfect detector."""
    import glob

    from PIL import Image

    from mvuld_tpu_torch.ocr.detect import resize_to_32
    from mvuld_tpu_torch.ocr.gt import rasterize_gt
    from mvuld_tpu_torch.tools.render import load_norm_pos
    seen = {}

    def apply_fn(_params, x):
        x = np.asarray(x)[0]
        for path in sorted(glob.glob(os.path.join(str(img_dir), "*.png"))):
            if path not in seen:
                r = (resize_to_32(Image.open(path).convert("RGB")) - 0.5) / 0.5
                h, w = r.shape[:2]
                seen[path] = (np.pad(r, ((0, -h % pad_to), (0, -w % pad_to),
                                         (0, 0)), constant_values=1.0), w, h)
            ref, w, h = seen[path]
            if ref.shape == x.shape and np.array_equal(ref, x):
                stem = os.path.splitext(os.path.basename(path))[0]
                boxes = load_norm_pos(os.path.join(str(pos_dir),
                                                   f"{stem}.pkl")).values()
                quads = [_box_quad(x0 * w, y0 * h, x1 * w, y1 * h)
                         for (x0, y0, x1, y1) in boxes]
                score, geo, _ = rasterize_gt(quads, *x.shape[:2])
                return score[None], geo[None]
        raise AssertionError("the detector's input is none of the images")
    return apply_fn


def read_pickles(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = pickle.load(f)
    return out
