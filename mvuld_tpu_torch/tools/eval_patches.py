"""Patched-function evaluation over TRAINED detectors, in PyTorch.

Counterpart of ``mvuld_tpu/tools/eval_patches.py`` (reference:
baselines/scripts/eval_patches.py:38-615, plot_embedding:566): each trained
detector scores the vulnerable (``func_before``) and patched
(``func_after``) versions of vulnerable functions, and the report says
whether the prediction flips after the fix, plus a t-SNE of the learned
representations.

  python -m mvuld_tpu_torch.tools.eval_patches --model devign \\
      --ckpt runs/baseline_devign --synthetic 200 --hard --out artifacts/pe \\
      [--device cuda|cpu]

  --model ∈ {devign, reveal, ivdetect, text, e2e}
  --ckpt   the trainer output dir: baseline_ckpt.pkl for the graph
           baselines (``train_baseline --out-dir``, either package's), a
           port ``train_text`` run dir (config.json + tokenizer.json +
           checkpoints), or a port ``train_e2e`` run dir (served through
           ``train/predict.py``).

Twins come from the corpus' ``func_after`` column when present (``--data``,
pandas), else from the synthetic twin generators (``--hard`` → hard_twin's
value-binding pairs; default → the template twins). The graph featurizers
read rows without pandas (``train_baseline.CodeRows``).

Artifacts: ``{out}/patch_eval.json`` (flip-rate table + delta stats) and
``{out}/tsne_{model}.png`` (representation scatter; matplotlib, sklearn)
when the model exposes representations.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def build_twins(args) -> Tuple[List[str], List[str]]:
    """(vulnerable, patched) source pairs."""
    if args.data:
        import pandas as pd
        df = pd.read_pickle(args.data)
        if "func_after" not in df.columns:
            raise ValueError(f"{args.data} has no func_after column")
        rows = df[(df.vul == 1) & (df.func_before != df.func_after)]
        if "label" in df.columns:          # test partition only, like the
            rows = rows[rows.label == "test"]   # reference's vuln-only ds
        return rows.func_before.tolist(), rows.func_after.tolist()
    import random

    from mvuld_tpu_torch.tools.patch_eval import make_patch_pairs
    if args.hard:
        from mvuld_tpu_torch.tools.synthetic import hard_twin
        rng = random.Random(args.seed)
        pairs = [hard_twin(rng) for _ in range(args.synthetic)]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return make_patch_pairs(args.synthetic, seed=args.seed)


def _valid_code(code: str, gtype: str = "all") -> bool:
    from mvuld_tpu_torch.tools.cpg import extract_line_cpg
    cpg = extract_line_cpg(code)
    return cpg is not None and len(cpg.filtered(gtype).nodes) >= 2


def make_baseline_fns(ckpt_dir: str, batch_size: int, device="cuda"
                      ) -> Tuple[Callable, Optional[Callable]]:
    """(prob_fn, repr_fn) for a train_baseline checkpoint dir; the model
    runs on ``device``."""
    import torch

    from mvuld_tpu_torch.tools.embeddings import EmbeddingTable
    from mvuld_tpu_torch.train.predict import resolve_device
    from mvuld_tpu_torch.train.train_baseline import (GRAPH_KEYS,
                                                      IVDETECT_KEYS, CodeRows,
                                                      baseline_from_ckpt,
                                                      build_graph_features,
                                                      build_ivdetect_features,
                                                      load_baseline_ckpt)

    device = resolve_device(str(device))
    ck = load_baseline_ckpt(ckpt_dir)
    emb = EmbeddingTable(ck["emb_vocab"], ck["emb_vectors"])
    max_nodes = ck["max_nodes"]
    name = ck["model"]
    model, ml = baseline_from_ckpt(ck, device)

    def batches(data, keys):
        for b in range(0, len(data["label"]), batch_size):
            yield tuple(torch.as_tensor(data[k][b:b + batch_size],
                                        device=device) for k in keys)

    if name == "ivdetect":
        @torch.no_grad()
        def run(codes, want_repr=False):
            data = build_ivdetect_features(CodeRows(codes), emb,
                                           max_nodes)["test"]
            probs = []
            for a in batches(data, IVDETECT_KEYS):
                e = np.exp(model(*a).cpu().numpy().astype(np.float64))
                probs.append((e / e.sum(-1, keepdims=True))[:, 1])
            return np.concatenate(probs), None

        return run, None

    @torch.no_grad()
    def run(codes, want_repr=False):
        data = build_graph_features(CodeRows(codes), emb, max_nodes)["test"]
        probs, reprs = [], []
        for a in batches(data, GRAPH_KEYS):
            if name == "devign":
                logits = model(*a).cpu().numpy().astype(np.float64)
                probs.append(1 / (1 + np.exp(-logits)))
            else:
                _, rep = model(*a, return_repr=True)
                logp, h = ml(rep)
                probs.append(np.exp(logp.cpu().numpy().astype(np.float64))
                             [:, 1])
                reprs.append(h.cpu().numpy())
        return (np.concatenate(probs),
                np.concatenate(reprs) if reprs else None)

    return run, None


def make_text_fns(run_dir: str, batch_size: int, device="cuda"):
    """(prob_fn, repr) for a port ``train_text`` run dir (cUniXcoder
    baseline): P(vul) from the classifier's softmax, representations its
    sentence embeddings (the encoder the embedder would run)."""
    import torch

    from mvuld_tpu_torch.config import load_saved_config
    from mvuld_tpu_torch.core.checkpoint import (auto_resume_helper,
                                                 resume_bestf1_helper,
                                                 restore)
    from mvuld_tpu_torch.data.tokenizer import CodeTokenizer
    from mvuld_tpu_torch.models.unixcoder import UniXcoderClassifier
    from mvuld_tpu_torch.train.predict import _resolve_run_dir, resolve_device
    from mvuld_tpu_torch.train.train_text import roberta_config

    device = resolve_device(str(device))
    run_dir = _resolve_run_dir(run_dir)   # descend OUTPUT/<model>/<tag>
    cfg = load_saved_config(run_dir)
    tok = CodeTokenizer.load(os.path.join(run_dir, "tokenizer.json"))
    ckpt = resume_bestf1_helper(run_dir) or auto_resume_helper(run_dir)
    if not ckpt:
        raise FileNotFoundError(f"no checkpoint under {run_dir}")
    model = UniXcoderClassifier(roberta_config(cfg, tok.vocab_size),
                                num_classes=cfg.MODEL.NUM_CLASSES)
    restore(ckpt, model)
    model.to(device).eval()

    @torch.no_grad()
    def run(codes, want_repr=False):
        ids = tok.tokenize(list(codes), max_length=cfg.DATA.FUNC_TOKENS)
        probs, reprs = [], []
        for b in range(0, len(codes), batch_size):
            chunk = torch.as_tensor(ids[b:b + batch_size], device=device)
            logits, sent = model(chunk)
            probs.append(torch.softmax(logits.float(), dim=-1)[:, 1]
                         .cpu().numpy().astype(np.float64))
            if want_repr:
                reprs.append(sent.float().cpu().numpy())
        return (np.concatenate(probs),
                np.concatenate(reprs) if reprs else None)

    return run, None


def make_e2e_fns(run_dir: str, batch_size: int, workdir: str,
                 device="cuda"):
    """prob_fn for a port ``train_e2e`` run dir, served through
    ``train/predict.py`` (the raw-source → CPG → render → OCR-positions →
    tri-modal path); the codes go to it as ``{i}.c`` files."""

    def run(codes, want_repr=False, _tag=[0]):
        from mvuld_tpu_torch.train.predict import main as predict_main
        _tag[0] += 1
        sub = os.path.join(workdir, f"req{_tag[0]}")
        os.makedirs(sub, exist_ok=True)
        files = []
        for i, code in enumerate(codes):
            files.append(os.path.join(sub, f"{i}.c"))
            with open(files[-1], "w") as f:
                f.write(code)
        rows = predict_main(["--run-dir", run_dir, *files,
                             "--batch-size", str(batch_size),
                             "--workdir", sub, "--device", str(device)])
        by_id = {r["id"]: r.get("p_vul", 0.0) for r in rows}
        return (np.asarray([by_id.get(str(i), 0.0)
                            for i in range(len(codes))], np.float64), None)

    return run, None


def delta_lines(a: str, b: str) -> int:
    """#changed lines between the twins (the reference's per-pair `delta`
    column, eval_patches.py changes_stats)."""
    d = list(difflib.unified_diff(a.split("\n"), b.split("\n"), lineterm=""))
    return sum(1 for ln in d[2:] if ln[:1] in "+-")


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True,
                        choices=["devign", "reveal", "ivdetect", "text",
                                 "e2e"])
    parser.add_argument("--ckpt", required=True,
                        help="trainer output dir (see module docstring)")
    parser.add_argument("--synthetic", type=int, default=200)
    parser.add_argument("--hard", action="store_true")
    parser.add_argument("--data", default=None,
                        help="corpus pickle with a func_after column")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--out", default="runs/patch_eval")
    parser.add_argument("--no-tsne", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from mvuld_tpu_torch.core.logger import create_logger
    from mvuld_tpu_torch.tools.patch_eval import (evaluate_patches,
                                                  plot_embedding)
    from mvuld_tpu_torch.train.predict import resolve_device

    device = resolve_device(args.device)
    logger = create_logger(args.out)
    vul_codes, fix_codes = build_twins(args)

    # keep only pairs where BOTH versions produce a usable CPG (the graph
    # featurizers silently drop invalid rows, which would break pairing)
    if args.model in ("devign", "reveal", "ivdetect", "e2e"):
        keep = [i for i in range(len(vul_codes))
                if _valid_code(vul_codes[i]) and _valid_code(fix_codes[i])]
        vul_codes = [vul_codes[i] for i in keep]
        fix_codes = [fix_codes[i] for i in keep]
    logger.info(f"{len(vul_codes)} (vulnerable, patched) pairs")

    if args.model in ("devign", "reveal", "ivdetect"):
        run, _ = make_baseline_fns(args.ckpt, args.batch_size, device)
    elif args.model == "text":
        run, _ = make_text_fns(args.ckpt, args.batch_size, device)
    else:
        run, _ = make_e2e_fns(args.ckpt, args.batch_size,
                              os.path.join(args.out, "predict_cache"), device)

    want_repr = not args.no_tsne
    p_vul, r_vul = run(vul_codes, want_repr=want_repr)
    p_fix, r_fix = run(fix_codes, want_repr=want_repr)

    # evaluate_patches copies its inputs, so dispatch on content equality
    report = evaluate_patches(
        lambda cs: p_vul if cs == list(vul_codes) else p_fix,
        vul_codes, fix_codes)

    # reference pair table: among correctly-detected vulnerable functions,
    # how many patched twins are still flagged (eval_patches.py:452-466)
    pred_vul, pred_fix = p_vul > 0.5, p_fix > 0.5
    detected = pred_vul
    pat_as_1 = int((detected & pred_fix).sum())
    pat_as_0 = int((detected & ~pred_fix).sum())
    deltas = np.asarray([delta_lines(a, b)
                         for a, b in zip(vul_codes, fix_codes)], np.float64)

    def _qstats(mask):
        if not mask.any():
            return None
        q25, q50, q75 = np.percentile(deltas[mask], (25, 50, 75))
        return {"q25": q25, "q50": q50, "q75": q75,
                "mean": float(deltas[mask].mean())}

    report.update({
        "model": args.model,
        "recall_on_vul": float(detected.mean()),
        "pat_pred_as_1": pat_as_1,
        "pat_pred_as_0": pat_as_0,
        "still_flagged_ratio": float(pat_as_1 / max(detected.sum(), 1)),
        "delta_stats_flagged": _qstats(detected & pred_fix),
        "delta_stats_cleared": _qstats(detected & ~pred_fix),
    })

    os.makedirs(args.out, exist_ok=True)
    out_json = os.path.join(args.out, "patch_eval.json")
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2, default=float)
    logger.info(f"patch eval [{args.model}]: "
                f"flip_rate={report['flip_rate']:.3f} "
                f"vul_det={report['vul_detection_rate']:.3f} "
                f"patch_clean={report['patch_clean_rate']:.3f} → {out_json}")

    if want_repr and r_vul is not None and r_fix is not None:
        feats = np.concatenate([r_vul, r_fix])
        labels = np.concatenate([np.ones(len(r_vul), np.int64),
                                 np.zeros(len(r_fix), np.int64)])
        png = plot_embedding(feats, labels,
                             os.path.join(args.out, f"tsne_{args.model}.png"),
                             title=f"{args.model}: vulnerable vs patched")
        logger.info(f"t-SNE → {png}")
        report["tsne"] = png
    return report


if __name__ == "__main__":
    main()
