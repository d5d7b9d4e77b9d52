"""Bag-of-tokens probe vs corpus scale for the hard synthetic mode.

The port's copy of ``mvuld_tpu/tools/hardprobe.py`` on its
``tools/{cpg,dataset,synthetic}.py``; sklearn (and pandas, through the
corpus funnel) are imported when a probe runs: a host tool, which the GPU
machine (no sklearn, no pandas) does not run.

The round-4 notes anchored "the hard corpus is not token-separable" with a
single 800-sample probe (0.590 test acc vs 0.525 base rate). This tool runs
the SAME probe under the trainers' exact corpus protocol (generate_dataset →
prepare_corpus: clean → dedup → <100-line filter → stratified seed-42
split → 1:1 train rebalance) at any scale, so the 4× data-scaling study can
cite "surface tokens stay uninformative at 2400" with the identical split
the detectors saw.

Usage: python -m mvuld_tpu_torch.tools.hardprobe [--sizes 600 2400] [--seed 42]
Prints one JSON line per size.
"""

from __future__ import annotations

import argparse
import json


def _node_context_text(code: str) -> str:
    """The function rendered as the e2e node tower sees it under
    DATA.NODE_CONTEXT=deps: each node's line + its dependency-source lines
    (cpg.dep_context_lines), all concatenated. Bag-of-tokens over this is
    the leakage control for the context intervention: the context only
    changes token MULTIPLICITIES, so if the probe stays near base rate the
    label is still not surface-recoverable and any model gain is relational."""
    from mvuld_tpu_torch.tools.cpg import dep_context_lines, extract_line_cpg

    cpg = extract_line_cpg(code)
    if cpg is None:
        return code
    lines = code.split("\n")
    lns = [nd[0] for nd in cpg.nodes]
    return "\n".join(dep_context_lines(cpg, lns, lines))


def probe_at_scale(n: int, seed: int = 42, hard: bool = True,
                   node_context: bool = False) -> dict:
    from sklearn.feature_extraction.text import CountVectorizer
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import f1_score

    from mvuld_tpu_torch.tools.dataset import prepare_corpus
    from mvuld_tpu_torch.tools.synthetic import generate_dataset

    df = prepare_corpus(generate_dataset(n, seed=seed, hard=hard))
    tr = df[df.label == "train"]
    te = df[df.label == "test"]
    to_text = (_node_context_text if node_context else (lambda s: s))
    # same token pattern as tests/test_synthetic_hard.py:_probe_accuracy —
    # identifiers, integer literals, comparison operators
    vec = CountVectorizer(token_pattern=r"[A-Za-z_]\w*|\d+|[<>=!]+")
    Xtr = vec.fit_transform([to_text(s) for s in tr.func_before])
    Xte = vec.transform([to_text(s) for s in te.func_before])
    clf = LogisticRegression(max_iter=2000).fit(Xtr, tr.vul.values)
    pred = clf.predict(Xte)
    return {
        "corpus_size": n,
        "hard": hard,
        "node_context": node_context,
        "n_train": int(len(tr)),
        "n_test": int(len(te)),
        "test_base_rate": float(max(te.vul.mean(), 1 - te.vul.mean())),
        "probe_test_acc": float(clf.score(Xte, te.vul.values)),
        "probe_test_f1": float(f1_score(te.vul.values, pred)),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", type=int, nargs="+", default=[600, 2400])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--default-mode", action="store_true",
                   help="probe the default (non-hard) corpus instead")
    p.add_argument("--node-context", action="store_true",
                   help="probe the DATA.NODE_CONTEXT=deps node-text view "
                        "(leakage control for the context intervention)")
    args = p.parse_args(argv)
    for n in args.sizes:
        print(json.dumps(probe_at_scale(n, seed=args.seed,
                                        hard=not args.default_mode,
                                        node_context=args.node_context)))


if __name__ == "__main__":
    main()
