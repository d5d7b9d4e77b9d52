"""Recognizer font-generalization benchmark (host-only, no device).

The port's copy of ``mvuld_tpu/tools/fontbench.py`` on its
``ocr/recognize.LinenoReader`` and ``tools/render.py``; matplotlib and PIL
are imported when it runs: a host tool, like the reader it measures.

The reference uses Tesseract, whose multi-font training data makes it
robust to whatever face Graphviz happens to draw with
(reference OCR/detect.py:332). Our LinenoReader matches glyph
templates from a fixed font bank, so its generalization to UNSEEN faces
must be measured, not assumed. This tool renders synthetic CPGs in a
chosen face, crops each node label at the ORACLE layout box (detection is
evaluated separately — EAST H-mean 1.0 on the held-out style), runs
``LinenoReader.read`` on the crop, and reports per-face accuracy:

  python -m mvuld_tpu_torch.tools.fontbench --n 40 --faces all

Faces are drawn from the matplotlib-bundled ttf set (DejaVu family, STIX,
Computer Modern) — the only faces available in this environment. The
reader's template bank is printed alongside so "seen" vs "unseen" is
explicit in the output.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple


def _mpl_ttf(name: str) -> Optional[str]:
    import matplotlib
    p = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                     "fonts", "ttf", name)
    return p if os.path.exists(p) else None


# face name -> (ttf filename or None for PIL default bitmap, nominal size)
FACES: Dict[str, Tuple[Optional[str], int]] = {
    "default_bitmap": (None, 14),
    "dejavu_sans": ("DejaVuSans.ttf", 15),
    "dejavu_serif": ("DejaVuSerif.ttf", 15),
    "dejavu_mono": ("DejaVuSansMono.ttf", 15),
    "dejavu_sans_oblique": ("DejaVuSans-Oblique.ttf", 15),
    "stix_general": ("STIXGeneral.ttf", 16),
    "cm_roman": ("cmr10.ttf", 16),
    "cm_sans": ("cmss10.ttf", 16),
    "cm_typewriter": ("cmtt10.ttf", 16),
}


def eval_face(name: str, n_funcs: int, seed: int = 0,
              reader=None) -> Dict[str, float]:
    """Render n_funcs CPGs in the face; read each node label at its oracle
    box. Returns {total, correct, wrong, none, accuracy}."""
    from mvuld_tpu_torch.ocr.recognize import LinenoReader
    from mvuld_tpu_torch.tools.cpg import extract_line_cpg
    from mvuld_tpu_torch.tools.render import RenderStyle, layout, render_cpg
    from mvuld_tpu_torch.tools.synthetic import generate_dataset

    ttf, size = FACES[name]
    path = _mpl_ttf(ttf) if ttf else None
    if ttf and path is None:
        return {"skipped": 1.0}
    style = RenderStyle(font_size=size, font_path=path)
    reader = reader or LinenoReader()
    df = generate_dataset(n_funcs, seed=seed)
    total = correct = wrong = none = 0
    for _, row in df.iterrows():
        cpg = extract_line_cpg(row.func_before)
        if cpg is None:
            continue
        g = cpg.filtered("all")
        if len(g.nodes) < 2:
            continue
        img, _ = render_cpg(g, out_path=None, style=style)
        W, H = img.size
        for lineno, (x0, y0, x1, y1) in layout(g, style).items():
            pad = 2
            crop = img.crop((max(x0 - pad, 0), max(y0 - pad, 0),
                             min(x1 + pad, W), min(y1 + pad, H)))
            got = reader.read(crop)
            total += 1
            if got == lineno:
                correct += 1
            elif got is None:
                none += 1
            else:
                wrong += 1
    return {"total": total, "correct": correct, "wrong": wrong,
            "none": none, "accuracy": round(correct / max(total, 1), 4)}


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=30,
                        help="synthetic functions per face")
    parser.add_argument("--faces", default="all",
                        help="comma list of face names, or 'all'")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    names = list(FACES) if args.faces == "all" else args.faces.split(",")
    from mvuld_tpu_torch.ocr.recognize import LinenoReader
    reader = LinenoReader()
    results = {}
    for name in names:
        results[name] = eval_face(name, args.n, seed=args.seed, reader=reader)
        print(f"{name:22s} {json.dumps(results[name])}", flush=True)
    return results


if __name__ == "__main__":
    main()
