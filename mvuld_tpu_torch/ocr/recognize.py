"""Glyph-template text recognizer — the self-contained Tesseract replacement.

The reference runs Tesseract over each detected node box and regex-extracts
the node's line-number label (reference: OCR/detect.py:285-353, pattern
``NTYPE_lineno: code``). Tesseract is not available in this environment, and
is unnecessary: the renderer draws labels in a known font, so recognition
reduces to per-glyph template correlation:

  1. binarize the crop, find text rows,
  2. segment glyphs by connected columns,
  3. classify each glyph against templates rendered with the SAME font the
     renderer uses (tools/render.py),
  4. ``lineno_from_text`` extracts the ``_<digits>:`` label.

Accuracy is measured against the renderer's ground-truth boxes in the tests.

Counterpart of ``mvuld_tpu/ocr/recognize.py``, the same algorithm and the
same cv2 calls (``moments``, ``warpAffine``, ``resize`` INTER_AREA,
``GaussianBlur``, ``connectedComponents[WithStats]``, ``morphologyEx``). The
templates are drawn with PIL fonts (``ImageFont.load_default`` and the
matplotlib-shipped DejaVu faces), so the reader runs only where PIL and
cv2 are: the CPU host that renders the corpus, not the GPU machine. PIL
and cv2 are imported inside the functions, so the module imports without
them.
"""

from __future__ import annotations

import re
import string
from typing import Dict, List, Optional

import numpy as np

_CHARSET = string.digits + string.ascii_uppercase + string.ascii_lowercase + "_:();=+-*,[]{}<>"
_FONT_SIZE = 14
_NORM = 24     # glyphs are resize-normalized to _NORM×_NORM for matching


def _render_glyph(ch: str, font) -> np.ndarray:
    from PIL import Image, ImageDraw

    img = Image.new("L", (28, 28), 255)
    d = ImageDraw.Draw(img)
    d.text((2, 2), ch, fill=0, font=font)
    arr = 255 - np.asarray(img, np.float32)
    # identical preprocessing to recognize()'s crops: faint anti-aliased
    # pixels below the binarization floor never reach the matcher
    arr = np.where(arr > 110, arr, 0.0)
    cols = arr.max(axis=0) > 32
    rows = arr.max(axis=1) > 32
    if not cols.any() or not rows.any():
        return np.zeros((1, 1), np.float32)
    arr = arr[np.ix_(rows.nonzero()[0], cols.nonzero()[0])]
    return arr / max(arr.max(), 1.0)


# Training faces for the template bank — like Tesseract's multi-font
# training data: one sans, one serif, one monospace cover the families a
# real Graphviz deployment draws with (Graphviz's default label face is
# Times/serif; Linux installs map it to DejaVu/Liberation). Faces NOT
# listed here stay genuinely unseen for the generalization benchmark
# (tools/fontbench.py): DejaVu oblique variants, STIXGeneral, and the
# Computer Modern family are never templated.
_BANK_TTFS = ("DejaVuSans.ttf", "DejaVuSerif.ttf", "DejaVuSansMono.ttf")


def _template_fonts(font_size: int) -> list:
    """Template font bank: the renderer's default bitmap face plus the
    matplotlib-shipped text families above, each at two sizes. More faces
    only add template variants; matching stays per-glyph max-correlation."""
    from PIL import ImageFont

    fonts = []
    # multiple sizes per face: glyphs are resize-normalized for matching,
    # but stroke-weight/proportion rendering differs enough across sizes
    # (bitmap '5' at 22 px vs a 14 px template) to flip close digit pairs
    sizes = (font_size, font_size + 3, font_size + 8)
    try:
        for sz in sizes:
            fonts.append(ImageFont.load_default(size=sz))
    except TypeError:
        fonts.append(ImageFont.load_default())
    try:
        import os

        import matplotlib
        d = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                         "fonts", "ttf")
        for ttf in _BANK_TTFS:
            p = os.path.join(d, ttf)
            if os.path.exists(p):
                for sz in sizes:
                    fonts.append(ImageFont.truetype(p, sz))
    except ImportError:
        pass
    return fonts


class GlyphRecognizer:
    def __init__(self, charset: str = _CHARSET, font_size: int = _FONT_SIZE):
        # variants are (normalized template, aspect ratio, raw pixel height);
        # matching restricts to variants near the query's height — glyph
        # proportions drift with rendered size, and letting a 22-px '5'
        # template compete for a 12-px '6' query flips close digit pairs
        self.templates: Dict[str, list] = {}
        for font in _template_fonts(font_size):
            for ch in charset:
                t = _render_glyph(ch, font)
                if t.size > 1:
                    self.templates.setdefault(ch, []).append(
                        (self._norm_glyph(t),
                         t.shape[1] / max(t.shape[0], 1), t.shape[0]))

    # -- glyph classification -------------------------------------------------
    @staticmethod
    def _norm_glyph(g: np.ndarray) -> np.ndarray:
        import cv2
        # grayscale (not binarized) matching: anti-aliased stroke intensity
        # carries shape detail the threshold destroys — measured margins
        # between confusable digits (6/8/9/0) are ~50% wider in gray
        g = g.astype(np.float32)
        g = g / max(float(g.max()), 1.0)
        # moment deslant (standard OCR normalization, cf. Tesseract's
        # baseline/italic normalization): shear = mu11/mu02 maps oblique/
        # italic strokes upright before correlation. Upright faces have
        # shear ≈ 0 so the transform is a near-no-op for them.
        h, w = g.shape
        if h >= 3 and w >= 2:
            m = cv2.moments(g)
            if m["mu02"] > 1e-3:
                shear = float(np.clip(m["mu11"] / m["mu02"], -0.8, 0.8))
                if abs(shear) > 0.05:
                    cy = m["m01"] / max(m["m00"], 1e-6)
                    M = np.float32([[1, -shear, shear * cy], [0, 1, 0]])
                    pad = int(abs(shear) * h) + 1
                    M[0, 2] += pad / 2
                    g = cv2.warpAffine(g, M, (w + pad, h))
                    cols = g.max(axis=0) > 0.1
                    if cols.any():
                        c = cols.nonzero()[0]
                        g = g[:, c[0]: c[-1] + 1]
        g = cv2.resize(g, (_NORM, _NORM), interpolation=cv2.INTER_AREA)
        # slight blur before correlation: tolerance to stroke-weight and
        # hinting differences across faces (multi-font robustness)
        g = cv2.GaussianBlur(g, (3, 3), 0.7)
        n = np.linalg.norm(g)
        return g / n if n > 0 else g

    # typographic invariant: enclosed-counter (hole) count per digit. '4'
    # is open-top in some faces and closed in others, so both are allowed.
    _DIGIT_HOLES = {"0": {1}, "1": {0}, "2": {0}, "3": {0}, "4": {0, 1},
                    "5": {0}, "6": {1}, "7": {0}, "8": {2}, "9": {1}}

    def _digit_score(self, g: np.ndarray):
        """Best (digit, score) for a glyph crop, with a soft topology prior:
        hole count disambiguates the open-vs-closed-bowl pairs (5/6, 6/8)
        whose grayscale correlations sit within a few percent of each other
        in unseen faces. Soft (x0.93) because thin strokes can break a loop
        open after binarization."""
        gn = self._norm_glyph(g)
        holes = _hole_counts(g)
        hq = g.shape[0]
        best, best_score = "", -1.0
        for ch, variants in self.templates.items():
            if not ch.isdigit():
                continue
            prior = 1.0 if holes & self._DIGIT_HOLES[ch] else 0.93
            for t, _ar, th in variants:
                if not (0.55 * hq <= th <= 1.8 * hq):
                    continue
                sc = float((gn * t).sum()) * prior
                if sc > best_score:
                    best, best_score = ch, sc
        if best_score < 0:    # query outside every size bucket: use all
            for ch, variants in self.templates.items():
                if not ch.isdigit():
                    continue
                prior = 1.0 if holes & self._DIGIT_HOLES[ch] else 0.93
                for t, _ar, _th in variants:
                    sc = float((gn * t).sum()) * prior
                    if sc > best_score:
                        best, best_score = ch, sc
        return best, best_score

    def _match(self, glyph: np.ndarray) -> str:
        if glyph.size == 0 or glyph.max() <= 0:
            return ""
        g = self._norm_glyph(glyph)
        ar_g = glyph.shape[1] / max(glyph.shape[0], 1)
        hq = glyph.shape[0]
        best, best_score = "", -1.0
        for widen in (False, True):
            for ch, variants in self.templates.items():
                for t, ar_t, th in variants:
                    if not widen and not (0.55 * hq <= th <= 1.8 * hq):
                        continue
                    score = float((g * t).sum())
                    # aspect-ratio prior distinguishes e.g. '_' from '-',
                    # ':' from ';'
                    ar_penalty = min(ar_g, ar_t) / max(ar_g, ar_t)
                    score *= 0.6 + 0.4 * ar_penalty
                    if score > best_score:
                        best, best_score = ch, score
            if best_score >= 0:   # a size bucket matched; no need to widen
                break
        return best if best_score > 0.3 else ""

    def recognize(self, crop) -> str:
        """Recognize a single text line inside a crop (a PIL image).

        Node crops include the ellipse outline the renderer draws around the
        label; any ink component touching the crop border is structural (the
        ellipse/edges always reach the border) and is removed before glyph
        segmentation."""
        arr = 255 - np.asarray(crop.convert("L"), np.float32)
        if arr.size == 0:
            return ""
        # aggressive binarization breaks anti-aliasing bridges between glyphs
        arr = np.where(arr > 110, arr, 0.0)
        try:
            import cv2
            n, labels = cv2.connectedComponents((arr > 0).astype(np.uint8))
            border = set(np.unique(np.concatenate([
                labels[0], labels[-1], labels[:, 0], labels[:, -1]])))
            border.discard(0)
            if border and n - 1 > len(border):
                mask = ~np.isin(labels, list(border))
                arr = arr * mask
        except ImportError:
            pass
        rows = arr.max(axis=1) > 0
        if not rows.any():
            return ""
        r0, r1 = rows.nonzero()[0][[0, -1]]
        band = arr[r0: r1 + 1]
        col_ink = band.max(axis=0) > 0
        # split into glyphs at empty columns
        text = []
        in_glyph = False
        start = 0
        gaps: List[int] = []
        segments = []
        for i, on in enumerate(col_ink.tolist() + [False]):
            if on and not in_glyph:
                start = i
                in_glyph = True
            elif not on and in_glyph:
                segments.append((start, i))
                in_glyph = False
        # split over-wide segments (touching glyphs) at their weakest column
        med_w = np.median([e - s for (s, e) in segments]) if segments else 0
        refined = []
        for (s, e) in segments:
            seg = [(s, e)]
            while seg and med_w > 2 and (seg[-1][1] - seg[-1][0]) > 1.8 * med_w:
                a, b = seg.pop()
                ink = band[:, a:b].sum(axis=0)
                lo, hi = int(0.3 * (b - a)), int(0.7 * (b - a))
                cut = a + lo + int(np.argmin(ink[lo:hi])) if hi > lo else a + (b - a) // 2
                seg.extend([(a, cut), (cut, b)])
                seg.sort()
            refined.extend(seg)
        prev_end = None
        for (s, e) in refined:
            if e - s < 1:
                continue
            if prev_end is not None and s - prev_end > 4:
                text.append(" ")
            prev_end = e
            glyph = band[:, s:e]
            gr = glyph.max(axis=1) > 0
            if gr.any():
                g0, g1 = gr.nonzero()[0][[0, -1]]
                glyph = glyph[g0: g1 + 1]
            text.append(self._match(glyph))
        del gaps
        return "".join(text)


def _hole_counts(g: np.ndarray) -> set:
    """Enclosed-background-region (typographic counter) counts of a glyph
    crop, measured both RAW and after a 3x3 morphological close, returned
    as a set. The close heals the 1-px stroke breaks thin faces leave
    after binarization (a broken '8' reads 0 holes raw) — but it can also
    seal a genuinely open aperture (a tight '5' bowl reads 1 hole closed),
    so topology is "consistent" when EITHER measurement matches."""
    try:
        import cv2
    except ImportError:
        return {-1}
    binary = np.pad((g > 0).astype(np.uint8), 2)
    out = set()
    for b in (binary, cv2.morphologyEx(binary, cv2.MORPH_CLOSE,
                                       np.ones((3, 3), np.uint8))):
        n_bg, _ = cv2.connectedComponents((1 - b).astype(np.uint8))
        out.add(max(int(n_bg) - 2, 0))   # minus label-0 and outer region
    return out


def _hole_count(g: np.ndarray) -> int:
    """Closed-form counter count (see _hole_counts); kept for tests."""
    counts = _hole_counts(g)
    return max(counts) if counts != {-1} else -1


def _split_wide_components(comps: List[tuple], band: np.ndarray,
                           Hb: int) -> List[tuple]:
    """Split components too WIDE to be one digit (w > 0.95 x band height;
    text-face digits are always narrower than tall) at their weakest ink
    column — monospace faces like Computer Modern typewriter draw '4' with
    a full-advance crossbar, so neighboring digits fuse into one component."""
    out: List[tuple] = []
    for (x, y, w, h) in comps:
        todo, spans = [(x, x + w)], []
        while todo:
            a, b = todo.pop()
            if b - a > 0.95 * Hb and b - a >= 4:
                ink = band[:, a:b].sum(axis=0)
                lo, hi = int(0.3 * (b - a)), int(0.7 * (b - a))
                cut = (a + lo + int(np.argmin(ink[lo:hi]))
                       if hi > lo else a + (b - a) // 2)
                todo.extend([(a, cut), (cut, b)])
            elif b > a:
                spans.append((a, b))
        out.extend((s, y, e - s, h) for (s, e) in sorted(spans))
    return sorted(out)


def _merge_split_components(comps: List[tuple], Hb: int) -> List[tuple]:
    """Merge bounding boxes of glyph pieces that belong to one digit.

    Input: (x, y, w, h) boxes sorted by x. Two consecutive boxes merge when
    both are too NARROW to be whole digits (w < 0.4 x band height — the two
    arcs of a stroke-broken '0' are each ~0.25Hb wide) and nearly touch in
    x (gap <= 1), or when their x-ranges overlap by at least half the
    narrower box (the stacked halves of a stem-broken '5') — AND the merged
    box still has digit proportions (width <= 0.8 x band height). Whole
    digits in tight faces can sit 1 px apart, so the gap test alone is not
    safe: the width precondition is what keeps real neighbors separate."""
    merged: List[list] = []
    for (x, y, w, h) in comps:
        if merged:
            mx, my, mw, mh = merged[-1]
            gap = x - (mx + mw)
            overlap = min(mx + mw, x + w) - max(mx, x)
            new_w = max(mx + mw, x + w) - min(mx, x)
            both_narrow = max(w, mw) < 0.4 * Hb
            if (((gap <= 1 and both_narrow)
                 or overlap >= 0.5 * min(w, mw))
                    and new_w <= 0.8 * Hb):
                nx0, ny0 = min(mx, x), min(my, y)
                ny1 = max(my + mh, y + h)
                merged[-1] = [nx0, ny0, new_w, ny1 - ny0]
                continue
        merged.append([x, y, w, h])
    return [tuple(m) for m in merged]


def _segments_of(band: np.ndarray):
    col_ink = band.max(axis=0) > 0
    segments, in_glyph, start = [], False, 0
    for i, on in enumerate(col_ink.tolist() + [False]):
        if on and not in_glyph:
            start, in_glyph = i, True
        elif not on and in_glyph:
            segments.append((start, i))
            in_glyph = False
    return segments


class LinenoReader(GlyphRecognizer):
    """Structural reader for the ``NTYPE_lineno:`` label prefix.

    Instead of full-text OCR, it finds the underscore (wide, flat, ink only
    near the baseline) and the following colon (narrow, two vertical blobs),
    then classifies the glyphs between them against DIGIT templates only —
    a 10-class problem the template matcher solves reliably."""

    def _read_components(self, band: np.ndarray, Hb: int) -> Optional[int]:
        """Connected-component structural parse. Column segmentation (the
        fallback below) fails on proportional faces whose underscore advances
        UNDER the previous glyph (DejaVu kerning merges their column spans);
        components keep the underscore separate regardless of kerning."""
        try:
            import cv2
        except ImportError:
            return None
        n, _labels, stats, _cent = cv2.connectedComponentsWithStats(
            (band > 0).astype(np.uint8))
        if n < 4:
            return None
        comps = [tuple(int(v) for v in stats[i][:4]) for i in range(1, n)]
        comps.sort(key=lambda c: c[0])
        # a real underscore is a WIDE flat bar near the baseline; the width
        # floor keeps 1-px baseline dots (a colon's bottom blob, serif
        # fragments) from being mistaken for one, and the clear-above test
        # rejects the bottom bar of '=' in the code text (an underscore
        # hangs below the baseline with its own advance width — nothing
        # sits on top of it)
        def clear_above(c) -> bool:
            if c[1] == 0:
                return True
            above = band[: c[1], c[0]: c[0] + c[2]]
            return float((above.max(axis=0) > 0).mean()) <= 0.4

        unders = [c for c in comps
                  if c[1] > 0.6 * Hb and c[3] <= 0.35 * Hb
                  and c[2] >= max(c[3], 0.3 * Hb) and clear_above(c)]
        # colon = two small ink blobs stacked on (nearly) the same x-span;
        # the x tolerance grows with their vertical separation so italic/
        # oblique faces (dots offset by the slant, ~0.2 x the gap) still
        # pair up
        small = [c for c in comps if c[2] <= 0.35 * Hb and c[3] <= 0.4 * Hb]
        colons = []
        for i, a in enumerate(small):
            for b in small[i + 1:]:
                vsep = max(b[1] - (a[1] + a[3]), a[1] - (b[1] + b[3]))
                if (vsep >= 0 and abs(a[2] - b[2]) <= 1
                        and abs(a[0] - b[0]) <= 1 + 0.3 * vsep):
                    colons.append((min(a[0], b[0]),
                                   min(a[1], b[1]), max(a[2], b[2])))
        def classify_between(left_x: int, right_x: int,
                             floor: float) -> Optional[int]:
            """Digits of the components strictly between two x bounds.

            Thin-stroke faces (STIX '0', Computer Modern '5') can BREAK one
            digit into several components after binarization; real digits
            in a number keep >=1 px of x-gap, broken pieces touch
            (x-gap <= 0) or stack (x-overlap) — merge those before
            classification; then split boxes too wide for one digit (fused
            monospace crossbars)."""
            # low pre-filter so a broken digit's small piece (a '2' whose
            # bottom bar disconnects) survives to the merge; the STRICT
            # right bound keeps the colon's own blobs out, and the
            # post-merge height floor drops whatever small debris stays
            # unmerged
            between = [c for c in comps
                       if c[0] >= left_x - 1 and c[0] + c[2] <= right_x
                       and c[3] >= 2]
            between = _merge_split_components(sorted(between), Hb)
            between = [c for c in _split_wide_components(between, band, Hb)
                       if c[3] > 0.4 * Hb]
            if not (0 < len(between) <= 4):
                return None
            digits = []
            for (x, y, w, h) in sorted(between):
                best, score = self._digit_score(band[y: y + h, x: x + w])
                if score < floor:
                    return None
                digits.append(best)
            return int("".join(digits)) if digits else None

        for u in unders:
            u_right = u[0] + u[2]
            for cx, _cy, _cw in sorted(c for c in colons if c[0] >= u_right):
                got = classify_between(u_right, cx, 0.25)
                if got is not None:
                    return got
        # Degenerate-separator fallback: TeX-encoded faces (matplotlib's
        # Computer Modern cmr10/cmss10) map ASCII '_' to a tiny accent
        # glyph, so no baseline underscore exists — the label still reads
        # "letters <tiny sep> digits <colon> code". Accept any small
        # free-standing component as the separator, at a HIGHER digit-
        # confidence floor since the structure is weaker. Only reached
        # when no underscore parse succeeded, so faces with a real
        # underscore never take this path.
        tall = [c for c in comps if c[3] > 0.4 * Hb]

        def free_standing(c) -> bool:
            """True when the small component shares no x-span with any tall
            glyph — stray serif/stroke fragments live inside a letter's or
            digit's x-range, the TeX dot stands alone between words."""
            return all(c[0] + c[2] <= t[0] or c[0] >= t[0] + t[2]
                       for t in tall)

        seps = [c for c in comps
                if c[2] <= 0.3 * Hb and c[3] <= 0.3 * Hb and free_standing(c)]
        for cx, _cy, _cw in sorted(c for c in colons):
            # nearest qualifying separator LEFT of the colon is the label's
            # '_' stand-in; scanning nearest-first keeps fragments earlier
            # in the NTYPE word from hijacking the parse
            for s in sorted((c for c in seps if c[0] + c[2] < cx),
                            key=lambda c: -(c[0] + c[2])):
                got = classify_between(s[0] + s[2], cx, 0.30)
                if got is not None:
                    return got
        return None

    def read(self, crop) -> Optional[int]:
        """The line number of an ``NTYPE_lineno:`` label in ``crop`` (a PIL
        image), or None."""
        arr = 255 - np.asarray(crop.convert("L"), np.float32)
        if arr.size == 0:
            return None
        arr = np.where(arr > 110, arr, 0.0)
        try:
            import cv2
            n, labels = cv2.connectedComponents((arr > 0).astype(np.uint8))
            border = set(np.unique(np.concatenate([
                labels[0], labels[-1], labels[:, 0], labels[:, -1]])))
            border.discard(0)
            if border and n - 1 > len(border):
                arr = arr * (~np.isin(labels, list(border)))
        except ImportError:
            pass
        rows = arr.max(axis=1) > 0
        if not rows.any():
            return None
        r0, r1 = rows.nonzero()[0][[0, -1]]
        band = arr[r0: r1 + 1]
        Hb = band.shape[0]
        got = self._read_components(band, Hb)
        if got is not None:
            return got
        segments = _segments_of(band)
        if len(segments) < 3:
            return None

        def is_underscore(s, e):
            g = band[:, s:e]
            gr = (g.max(axis=1) > 0).nonzero()[0]
            if len(gr) == 0:
                return False
            top, height = gr[0], gr[-1] - gr[0] + 1
            return (top > 0.6 * Hb and height <= 0.35 * Hb
                    and (e - s) >= height)

        def is_colon(s, e):
            g = band[:, s:e]
            gr = (g.max(axis=1) > 0).astype(np.int8)
            runs = np.diff(np.r_[0, (g.max(axis=1) > 0).astype(np.int8), 0])
            blobs = int((runs == 1).sum())
            return (e - s) <= 0.8 * Hb and blobs == 2

        for ui, (s, e) in enumerate(segments):
            if not is_underscore(s, e):
                continue
            # find the colon within the next few glyphs
            for ci in range(ui + 2, min(ui + 6, len(segments))):
                if not is_colon(*segments[ci]):
                    continue
                digits = []
                ok = True
                for (ds, de) in segments[ui + 1: ci]:
                    g = band[:, ds:de]
                    gr = (g.max(axis=1) > 0).nonzero()[0]
                    g = g[gr[0]: gr[-1] + 1]
                    best, score = self._digit_score(g)
                    if score < 0.25:
                        ok = False
                        break
                    digits.append(best)
                if ok and digits:
                    return int("".join(digits))
        return None


_CONFUSIONS = str.maketrans({"O": "0", "o": "0", "D": "0", "l": "1", "I": "1",
                             "i": "1", "S": "5", "B": "8", "Z": "2", "g": "9"})
# trailing class = glyphs OCR confuses with ':' (two stacked blobs read as
# i/j/I/l/| depending on blur and face)
_LINENO_RE = re.compile(r"[_\-]([0-9OolIiSBZgD]+?)[:;Iil|j]")


def lineno_from_text(text: str) -> Optional[int]:
    """Extract the line number from an ``NTYPE_lineno: code`` label
    (reference regex semantics, OCR/detect.py:318-340). Applies the usual
    OCR digit-confusion mapping inside the ``_…:`` span."""
    compact = text.replace(" ", "")
    m = _LINENO_RE.search(compact)
    if m:
        digits = m.group(1).translate(_CONFUSIONS)
        if digits.isdigit():
            return int(digits)
    # fallback: digit run before the first colon-ish separator
    head = re.split(r"[:;]", compact)[0]
    m = re.search(r"([0-9]+)$", head.translate(_CONFUSIONS))
    return int(m.group(1)) if m else None
