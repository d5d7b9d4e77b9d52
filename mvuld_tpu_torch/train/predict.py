"""Inference/serving CLI: raw C functions → P(vulnerable) on the GPU.

Counterpart of ``mvuld_tpu/train/predict.py``: CPG extraction
(tools/cpg.py), rendering (tools/render.py) with renderer-oracle node
positions or, with ``--east-ckpt``, EAST detection + line-number
recognition (``ocr/``, the reference's production OCR path), tokenization with the TRAINING vocabulary, and one eval forward
per power-of-two shape bucket. Split in two so each half can run alone:

  * ``build_request`` — host featurisation into the model's dense arrays
    (the same arrays as the JAX package's);
  * ``serve`` — the bucketed forward on ``device``, returning P(vul).

Weights come from the checkpoint the JAX CLI would take: ``--ckpt``, else
the run's newest best-F1 checkpoint, else its newest epoch checkpoint —
here the port trainer's own (``core/checkpoint.py``), restored with
``restore``. A run with no port checkpoint (a JAX run) serves from an
``.npz`` of its variables flattened with ``/`` keys (``models/convert.py``),
``RUN_DIR/variables.npz`` or a ``--ckpt`` ending in ``.npz``. On CUDA the
attention kernel always runs and the
fused MLP kernels follow the run's ``TRAIN.FUSED_MLP``, as the JAX package
gates its Pallas kernels on the TPU; on the CPU every layer runs plain.

Usage:
  python -m mvuld_tpu_torch.train.predict --run-dir runs/e2e file1.c ...
  python -m mvuld_tpu_torch.train.predict --run-dir runs/e2e --data corpus.pkl \
      --limit 64 --out preds.jsonl --device cuda
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


def _resolve_run_dir(path: str) -> str:
    """Accept the trainer's --output root or the nested OUTPUT dir
    (get_config appends MODEL.NAME/TAG): the run dir is wherever
    config.json landed next to the checkpoints."""
    if os.path.exists(os.path.join(path, "config.json")):
        return path
    cands = sorted(glob.glob(os.path.join(path, "**", "config.json"),
                             recursive=True), key=os.path.getmtime)
    if not cands:
        raise FileNotFoundError(
            f"no config.json under {path} — is this a finished run dir?")
    return os.path.dirname(cands[-1])


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def resolve_device(name: str):
    """``torch.device`` for ``name``; asking for CUDA without a card raises."""
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def build_request(sources: List[Tuple[str, str]], cfg, tok, workdir: str,
                  east_ckpt: Optional[str] = None, logger=None,
                  device="cuda") -> Tuple[Dict, List[Dict]]:
    """Host-side featurization of raw (id, code) pairs into the model's
    dense arrays. Returns (arrays, per-item info rows); unparseable or
    degenerate functions get an ``error`` row and no array slot. With
    ``east_ckpt`` the node positions come from EAST detection and
    line-number recognition over the rendered PNGs (the detector on
    ``device``; the reader needs PIL), written to ``workdir/pos_ocr``."""
    from mvuld_tpu_torch.data.graph_batch import pack_graph
    from mvuld_tpu_torch.data.tokenizer import normalize_line
    from mvuld_tpu_torch.data.transforms import load_image, resize_normalize
    from mvuld_tpu_torch.tools.cpg import extract_line_cpg
    from mvuld_tpu_torch.tools.render import (load_norm_pos, render_cpg,
                                              save_norm_pos)

    img_dir = os.path.join(workdir, "imgs")
    pos_dir = os.path.join(workdir, "pos")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pos_dir, exist_ok=True)

    rows: List[Dict] = []                         # one per input, in order
    ok: List[Tuple[str, str, object, str, Dict]] = []
    for sid, code in sources:
        row: Dict = {"id": sid}
        rows.append(row)
        cpg = extract_line_cpg(code)
        if cpg is None:
            row["error"] = "unparseable function"
            continue
        g = cpg.filtered(cfg.DATA.GTYPE)
        if len(g.nodes) < 2:
            # the reference drops these at dataset build (check_validity,
            # baselines/scripts/getImages.py:22-51)
            row["error"] = "degenerate graph (<2 nodes)"
            continue
        img_path = os.path.join(img_dir, f"{sid}.png")
        if not os.path.exists(img_path):
            _img, pos = render_cpg(g, out_path=img_path)
            save_norm_pos(pos, os.path.join(pos_dir, f"{sid}.pkl"))
        ok.append((sid, code, cpg, img_path, row))

    # node positions: renderer oracle, or the production OCR chain
    if east_ckpt and ok:
        from mvuld_tpu_torch.ocr.detect import (detect_dataset_map,
                                                load_east_detector)
        apply_fn, east_params = load_east_detector(east_ckpt, device)
        pos_dir = os.path.join(workdir, "pos_ocr")
        detect_dataset_map(apply_fn, east_params,
                           [img_path for (_, _, _, img_path, _) in ok],
                           pos_dir, pad_to=256, logger=logger)

    n = len(ok)
    M, T, Tn = cfg.DATA.MAX_NODES, cfg.DATA.FUNC_TOKENS, cfg.DATA.NODE_TOKENS
    S = cfg.DATA.IMG_SIZE
    pos_dim = 4 + 2 * int(cfg.DATA.NODE_NUMERIC)
    arrs = {
        "func_ids": np.full((n, T), tok.pad_id, np.int32),
        "node_ids": np.full((n, M, Tn), tok.pad_id, np.int32),
        "image": np.zeros((n, S, S, 3), np.float32),
        "pos": np.zeros((n, M, pos_dim), np.float32),
        "adj": np.zeros((n, M, M), np.uint8),
        "node_mask": np.zeros((n, M), np.float32),
    }
    for i, (sid, code, cpg, img_path, row) in enumerate(ok):
        pos_path = os.path.join(pos_dir, f"{sid}.pkl")
        pos_dict = (load_norm_pos(pos_path)
                    if os.path.exists(pos_path) else None)
        pg = pack_graph(cpg, M, pos_dict=pos_dict, gtype=cfg.DATA.GTYPE)
        arrs["pos"][i, :, :4], arrs["adj"][i] = pg.pos, pg.adj
        arrs["node_mask"][i] = pg.mask
        if cfg.DATA.NODE_NUMERIC:
            from mvuld_tpu_torch.tools.cpg import numeric_literal_feats
            arrs["pos"][i, : pg.num_nodes, 4:] = numeric_literal_feats(
                cpg, pg.lineno[: pg.num_nodes], code.split("\n"),
                k=int(cfg.DATA.NODE_NUMERIC))
        arrs["func_ids"][i] = tok.tokenize([code], max_length=T)[0]
        lines = code.split("\n")
        lns = pg.lineno[: pg.num_nodes]
        if cfg.DATA.NODE_CONTEXT == "deps":
            # serving must tokenize node text exactly like the run's cache
            from mvuld_tpu_torch.tools.cpg import dep_context_lines
            node_lines = [normalize_line(s)
                          for s in dep_context_lines(cpg, lns, lines)]
        else:
            node_lines = [normalize_line(lines[ln - 1])
                          if 1 <= ln <= len(lines) else "" for ln in lns]
        if node_lines:
            arrs["node_ids"][i, : pg.num_nodes] = tok.tokenize(
                node_lines, max_length=Tn)
        arrs["image"][i] = resize_normalize(load_image(img_path), S)
        row["num_nodes"] = int(pg.num_nodes)
        row["_slot"] = i
    return arrs, rows


def serve(model, arrs: Dict[str, np.ndarray], batch_size: int, device
          ) -> np.ndarray:
    """P(vul) for every row of ``arrs``: chunks of ``batch_size`` rows, the
    tail chunk padded (with copies of its first row) up to its power-of-two
    bucket, one eval forward each. ``model`` must already be on ``device``."""
    import torch

    B = max(batch_size, 1)
    n = arrs["func_ids"].shape[0]
    probs = np.zeros(n, np.float32)
    with torch.inference_mode():
        for lo in range(0, n, B):
            k = min(B, n - lo)
            bucket = _bucket(k, B)
            chunk = {}
            for key, v in arrs.items():
                c = v[lo:lo + k]
                if k < bucket:     # pad the tail chunk up to its bucket shape
                    c = np.concatenate([c, np.repeat(c[:1], bucket - k, 0)], 0)
                chunk[key] = torch.as_tensor(c).to(device)
            logits = model(chunk["func_ids"].long(), chunk["node_ids"].long(),
                           chunk["image"], chunk["pos"], chunk["adj"] > 0,
                           chunk["node_mask"])
            # P(vul): softmax prob of class 1, the reference's decision rule
            # (mvuld/main_bigvul.py:447)
            p = torch.softmax(logits.float(), dim=-1)[:, 1]
            probs[lo:lo + k] = p[:k].cpu().numpy()
    return probs


def main(argv=None) -> List[Dict]:
    parser = argparse.ArgumentParser()
    parser.add_argument("files", nargs="*", help=".c source files")
    parser.add_argument("--run-dir", required=True,
                        help="train_e2e output dir (config.json + "
                             "tokenizer.json)")
    parser.add_argument("--ckpt", default=None,
                        help="a port checkpoint, or an .npz of a JAX run's "
                             "variables with '/' keys (default: the run's "
                             "best-F1, then newest epoch checkpoint, then "
                             "RUN_DIR/variables.npz)")
    parser.add_argument("--east-ckpt", default=None,
                        help="trained EAST detector (train_east --out-dir "
                             "root, a checkpoint of it, or a JAX run's "
                             "variables as .npz): node positions then come "
                             "from EAST detection + line-number recognition "
                             "instead of the renderer's oracle boxes")
    parser.add_argument("--data", default=None,
                        help="corpus pickle (func_before/_id columns) to "
                             "predict over instead of .c files")
    parser.add_argument("--limit", type=int, default=0,
                        help="with --data: only the first N rows")
    parser.add_argument("--batch-size", type=int, default=16,
                        help="max shape bucket (chunks pad to powers of two "
                             "up to this)")
    parser.add_argument("--node-capacity", type=int, default=0,
                        help="packed per-line encoder capacity (0 = encode "
                             "every slot; params are identical either way)")
    parser.add_argument("--workdir", default=None,
                        help="where rendered PNGs/positions go (default: "
                             "RUN_DIR/predict_cache)")
    parser.add_argument("--out", default=None, help="write JSON lines here")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from mvuld_tpu_torch.config import load_saved_config
    from mvuld_tpu_torch.core.checkpoint import (auto_resume_helper,
                                                 resume_bestf1_helper,
                                                 restore)
    from mvuld_tpu_torch.data.tokenizer import CodeTokenizer
    from mvuld_tpu_torch.models.convert import jax_variables_to_torch
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model

    device = resolve_device(args.device)
    t_start = time.time()
    run_dir = _resolve_run_dir(args.run_dir)
    cfg = load_saved_config(run_dir)
    tok_path = os.path.join(run_dir, "tokenizer.json")
    if not os.path.exists(tok_path):
        raise FileNotFoundError(
            f"{tok_path} missing — the run predates tokenizer persistence; "
            "re-run train_e2e or copy the training tokenizer here")
    tok = CodeTokenizer.load(tok_path)
    ckpt = (args.ckpt or resume_bestf1_helper(run_dir)
            or auto_resume_helper(run_dir)
            or os.path.join(run_dir, "variables.npz"))
    if not os.path.exists(ckpt):
        raise FileNotFoundError(
            f"no port checkpoint under {run_dir} and {ckpt} missing — train "
            "with the port's train_e2e, or export the JAX run's variables to "
            "an .npz with '/' keys (README, PyTorch/CUDA port)")

    # ---- gather sources
    sources: List[Tuple[str, str]] = []
    for f in args.files:
        with open(f) as fh:
            sources.append((os.path.splitext(os.path.basename(f))[0],
                            fh.read()))
    if args.data:
        import pandas as pd
        df = pd.read_pickle(args.data)
        if args.limit:
            df = df.head(args.limit)
        # by column name: itertuples() renames the leading-underscore _id
        sources += [(str(sid), code)
                    for sid, code in zip(df["_id"], df["func_before"])]
    if not sources:
        parser.error("no inputs: pass .c files and/or --data")

    workdir = args.workdir or os.path.join(run_dir, "predict_cache")
    arrs, rows = build_request(sources, cfg, tok, workdir,
                               east_ckpt=args.east_ckpt, device=device)
    t_host = time.time() - t_start

    # ---- model: the kernels run on CUDA, the plain layers on the CPU
    B = max(args.batch_size, 1)
    cap = args.node_capacity or None
    if cap:
        cap = min(cap, B * cfg.DATA.MAX_NODES)
    on_gpu = device.type == "cuda"
    fused = on_gpu and bool(cfg.TRAIN.FUSED_MLP)
    model, _rcfg, _scfg = build_e2e_model(
        cfg, tok.vocab_size, node_capacity=cap, use_pallas=on_gpu,
        roberta_pallas_mlp=fused, use_pallas_mlp=fused)
    if ckpt.endswith(".npz"):
        with np.load(ckpt) as flat:
            jax_variables_to_torch(dict(flat), model)
    else:
        restore(ckpt, model)
    model.to(device).eval()

    t0 = time.time()
    probs = serve(model, arrs, B, device)
    t_infer = time.time() - t0
    n = arrs["func_ids"].shape[0]

    results: List[Dict] = []
    for row in rows:
        out = {k: v for k, v in row.items() if not k.startswith("_")}
        if "_slot" in row:
            p = float(probs[row["_slot"]])
            out["p_vul"] = round(p, 6)
            out["pred"] = int(p > 0.5)
        results.append(out)

    lines = [json.dumps(r) for r in results]
    summary = {
        "summary": True, "functions": n, "errors": len(rows) - n,
        "checkpoint": ckpt, "positions": "ocr" if args.east_ckpt else "oracle",
        "device": str(device),
        "host_prep_s": round(t_host, 2),
        "device_infer_s": round(t_infer, 2),
        "functions_per_sec_device": round(n / t_infer, 2) if t_infer else None,
    }
    lines.append(json.dumps(summary))
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return results


if __name__ == "__main__":
    main()
