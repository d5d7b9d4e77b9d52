"""Baseline trainers in PyTorch: Devign / ReVeal (two-stage) / IVDetect.

Counterpart of ``mvuld_tpu/train/train_baseline.py`` (reference:
baselines/models/{devign,reveal,ivdetect}/main.py) over the dense graph
layout: word2vec(100)+ntype-onehot(32) node features for the GGNN models
(reference: devign/dataset.py:125-151), SGNS embeddings trained on the
train split, GloVe token sequences for IVDetect's five channels, BCE/CE
training, and ReVeal's repr-export → SMOTE → metric-learning second stage
(reference: reveal/ggnn/main.py:114-157 → reveal/main.py:27-81).

Each split lives on the device once and batches are row-index vectors
gathered there; the batch order is the JAX package's
(``RandomState(seed).permutation`` per epoch) and the step is optax.adam's
(``core/optim.Optimizer``, no clipping, no decay). The three trainers take
models whose weights are already set (``main`` draws them with
``init_jax_like``; a test loads JAX's initial variables). The checkpoint
``baseline_ckpt.pkl`` holds the JAX package's payload, parameters as flax
trees, so either package serves the other's.

Usage:
  python -m mvuld_tpu_torch.train.train_baseline --model devign|reveal|ivdetect
      [--synthetic N] [--data corpus.pkl] [--epochs E] [--out-dir DIR]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np

from mvuld_tpu_torch.tools.vocab import NUM_NODE_TYPES

SEQ_LEN = 12      # per-channel token budget for IVDetect
GRAPH_KEYS = ["feats", "adj_etype", "node_mask"]
IVDETECT_KEYS = ["f_subseq", "m_subseq", "f_nametype", "m_nametype",
                 "f_data", "m_data", "f_control", "m_control",
                 "ast", "adj", "node_mask"]


class CodeRows:
    """Rows as ``build_*_features`` read them (``func_before``, ``vul``,
    ``label`` attributes, ``iterrows()``) without pandas."""

    def __init__(self, codes: Sequence[str],
                 vul: Optional[Sequence[int]] = None,
                 parts: Optional[Sequence[str]] = None):
        n = len(codes)
        self.rows = [SimpleNamespace(func_before=c, vul=v, label=p)
                     for c, v, p in zip(codes,
                                        [0] * n if vul is None else vul,
                                        ["test"] * n if parts is None
                                        else parts)]

    def iterrows(self):
        return enumerate(self.rows)


def save_baseline_ckpt(out_dir: str, payload: Dict) -> str:
    """Persist a trained baseline (params + its embedding table + the
    feature hyperparams) as the JAX package writes it: ``params`` /
    ``ml_params`` given as port modules become flax trees
    (``convert.baseline_params_tree``)."""
    import pickle

    from torch import nn

    from mvuld_tpu_torch.models.convert import baseline_params_tree
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "baseline_ckpt.pkl")
    payload = {k: (baseline_params_tree(v) if isinstance(v, nn.Module)
                   else v) for k, v in payload.items()}
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def load_baseline_ckpt(out_dir: str) -> Dict:
    import pickle
    path = (out_dir if out_dir.endswith(".pkl")
            else os.path.join(out_dir, "baseline_ckpt.pkl"))
    with open(path, "rb") as f:
        return pickle.load(f)


def baseline_from_ckpt(ck: Dict, device):
    """(model, metric learner or None) of a loaded checkpoint on
    ``device``, widths read from its parameters (the JAX package's CLI
    widths for its own checkpoints), weights through the converter."""
    from mvuld_tpu_torch.models.baselines import (DevignModel, GGNNSum,
                                                  IVDetect,
                                                  MetricLearningModel)
    from mvuld_tpu_torch.models.convert import (flatten_variables,
                                                jax_variables_to_torch)

    p = ck["params"]
    name = ck["model"]
    if name == "ivdetect":
        model = IVDetect(hidden=p["connect"]["kernel"].shape[1],
                         feat_dim=p["gru_subseq"]["GRUCell_0"]["ir"]
                         ["kernel"].shape[0])
    elif name == "devign":
        D = p["ggnn"]["etype_w"].shape[-1]
        model = DevignModel(input_dim=p["z_conv1"]["kernel"].shape[1] - D,
                            output_dim=D, num_steps=6, n_etypes=6)
    else:
        model = GGNNSum(output_dim=p["ggnn"]["etype_w"].shape[-1],
                        num_steps=8, n_etypes=6)
    jax_variables_to_torch(flatten_variables({"params": p}), model)
    ml = None
    if name == "reveal":
        layer1 = ck["ml_params"]["layer1"]["kernel"]
        ml = MetricLearningModel(layer1.shape[0], hidden_dim=layer1.shape[1])
        jax_variables_to_torch(flatten_variables({"params": ck["ml_params"]}),
                               ml)
        ml.to(device).eval()
    return model.to(device).eval(), ml


def build_graph_features(df, emb, cfg_max_nodes: int, gtype: str = "all"):
    """Pack graphs + compute node features for the GGNN baselines."""
    from mvuld_tpu_torch.data.graph_batch import pack_graph, per_etype_adjacency
    from mvuld_tpu_torch.tools.cpg import extract_line_cpg

    items = []
    for _, row in df.iterrows():
        cpg = extract_line_cpg(row.func_before)
        if cpg is None:
            continue
        g = cpg.filtered(gtype)
        if len(g.nodes) < 2:
            continue
        pg = pack_graph(cpg, cfg_max_nodes, gtype=gtype)
        lines = row.func_before.split("\n")
        feats = np.zeros((cfg_max_nodes, emb.dim + NUM_NODE_TYPES), np.float32)
        for i in range(pg.num_nodes):
            ln = int(pg.lineno[i])
            text = lines[ln - 1] if 1 <= ln <= len(lines) else ""
            feats[i, : emb.dim] = emb.get_embeddings(text)
            feats[i, emb.dim + int(pg.ntype[i])] = 1.0
        items.append({"pg": pg, "feats": feats, "label": int(row.vul),
                      "part": row.label})
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for part in ("train", "val", "test"):
        sel = [it for it in items if it["part"] == part]
        if not sel:
            continue
        adj = np.stack([it["pg"].adj for it in sel])
        out[part] = {
            "feats": np.stack([it["feats"] for it in sel]),
            "adj_etype": per_etype_adjacency(adj),
            "node_mask": np.stack([it["pg"].mask for it in sel]),
            "label": np.asarray([it["label"] for it in sel], np.int32),
        }
    return out


def build_ivdetect_features(df, emb, max_nodes: int):
    """Five per-node channels: token subseq, name/types, data-dep text,
    control-dep text (reference: ivdetect/dataset.py:122-301), plus AST and
    full adjacency."""
    from mvuld_tpu_torch.data.graph_batch import adjacency_for, pack_graph
    from mvuld_tpu_torch.tools.cpg import (C_KEYWORDS, TYPE_KEYWORDS,
                                           extract_line_cpg)
    from mvuld_tpu_torch.tools.embeddings import tokenize_code

    D = emb.dim
    out = {}
    items = []
    for _, row in df.iterrows():
        cpg = extract_line_cpg(row.func_before)
        if cpg is None:
            continue
        g = cpg.filtered("all")
        if len(g.nodes) < 2:
            continue
        pg = pack_graph(cpg, max_nodes, gtype="all")
        lines = row.func_before.split("\n")
        N = max_nodes
        chan = {k: np.zeros((N, SEQ_LEN, D), np.float32)
                for k in ("subseq", "nametype", "data", "control")}
        cmask = {k: np.zeros((N, SEQ_LEN), np.float32) for k in chan}
        # data/control dependency line sets from the unfiltered edge list
        deps = {"data": {}, "control": {}}
        for (a, b, t) in cpg.edges:
            if t == "REACHING_DEF":
                deps["data"].setdefault(b, []).append(a)
            elif t == "CDG":
                deps["control"].setdefault(b, []).append(a)

        def fill(key, i, text):
            toks = tokenize_code(text)[:SEQ_LEN]
            for k, tok in enumerate(toks):
                chan[key][i, k] = emb.vectors[emb.vocab.get(tok, 0)]
                cmask[key][i, k] = 1.0
            if not toks:
                cmask[key][i, 0] = 1.0

        for i in range(pg.num_nodes):
            ln = int(pg.lineno[i])
            text = lines[ln - 1] if 1 <= ln <= len(lines) else ""
            fill("subseq", i, text)
            idents = [t for t in tokenize_code(text)
                      if t not in C_KEYWORDS and t.isidentifier()]
            types = [t for t in tokenize_code(text) if t in TYPE_KEYWORDS]
            fill("nametype", i, " ".join(idents + types))
            # ALL dependent statements concatenated (the reference joins the
            # full dependency line set, ivdetect/dataset.py:122-301; the
            # token sequence is then capped at SEQ_LEN inside fill(), which
            # mirrors its GRU input truncation)
            fill("data", i, " ".join(
                lines[d - 1] for d in deps["data"].get(ln, [])
                if 1 <= d <= len(lines)))
            fill("control", i, " ".join(
                lines[d - 1] for d in deps["control"].get(ln, [])
                if 1 <= d <= len(lines)))
        items.append({
            "pg": pg, "chan": chan, "cmask": cmask, "label": int(row.vul),
            "part": row.label,
            "ast": adjacency_for(pg.adj[None], ["AST"])[0].astype(np.float32),
            "adj": adjacency_for(pg.adj[None], ["AST", "CFG", "CDG"])[0].astype(np.float32),
        })
    for part in ("train", "val", "test"):
        sel = [it for it in items if it["part"] == part]
        if not sel:
            continue
        out[part] = {
            **{f"f_{k}": np.stack([it["chan"][k] for it in sel])
               for k in ("subseq", "nametype", "data", "control")},
            **{f"m_{k}": np.stack([it["cmask"][k] for it in sel])
               for k in ("subseq", "nametype", "data", "control")},
            "ast": np.stack([it["ast"] for it in sel]),
            "adj": np.stack([it["adj"] for it in sel]),
            "node_mask": np.stack([it["pg"].mask for it in sel]),
            "label": np.asarray([it["label"] for it in sel], np.int32),
        }
    return out


def _on(split: Dict[str, np.ndarray], keys: Sequence[str], device) -> Dict:
    """One upload of a split's columns."""
    import torch
    return {k: torch.as_tensor(split[k], device=device) for k in keys}


def adam(model, lr: float):
    """optax.adam(lr) over ``model``'s parameters."""
    from mvuld_tpu_torch.core.optim import Optimizer
    params = list(model.named_parameters())
    return Optimizer(params, {n: False for n, _ in params}, lambda _: lr,
                     name="adamw", clip=None)


def bce_loss(model, batch: Dict):
    """Devign / GGNNSum: sigmoid BCE on the logits, batch mean."""
    import torch.nn.functional as F
    logits = model(*(batch[k] for k in GRAPH_KEYS))
    return F.binary_cross_entropy_with_logits(logits,
                                              batch["label"].to(logits.dtype))


def ce_loss(model, batch: Dict):
    """IVDetect: softmax CE on the two logits, batch mean."""
    import torch.nn.functional as F
    return F.cross_entropy(model(*(batch[k] for k in IVDETECT_KEYS)),
                           batch["label"].long())


def fit_epochs(model, train: Dict, keys: Sequence[str], loss_fn, epochs: int,
               lr: float, seed: int, batch_size: int, logger, device
               ) -> List[float]:
    """``epochs`` passes over ``train`` (uploaded once; batches gathered on
    the device from ``RandomState(seed).permutation`` order; a trailing
    part batch dropped) with Adam; the mean loss of each epoch."""
    import torch

    dtrain = _on(train, list(keys) + ["label"], device)
    opt = adam(model, lr)
    n = len(train["label"])
    rng_np = np.random.RandomState(seed)
    history = []
    for epoch in range(epochs):
        order = rng_np.permutation(n)
        losses = []
        for b in range(max(n // batch_size, 1)):
            idx = torch.as_tensor(order[b * batch_size:(b + 1) * batch_size],
                                  device=device)
            loss = loss_fn(model, {k: v[idx] for k, v in dtrain.items()})
            opt.update(torch.autograd.grad(loss, opt.params))
            losses.append(loss.detach())
        history.append(float(torch.stack(losses).mean()))
        logger.info(f"epoch {epoch}: loss {history[-1]:.4f}")
    return history


def _predict(model, split: Dict, keys: Sequence[str], batch_size: int,
             device) -> np.ndarray:
    """The model's outputs over a split in batches, eval mode, on the
    host."""
    import torch
    dd = _on(split, keys, device)
    out = []
    with torch.no_grad():
        for b in range(0, len(split["label"]), batch_size):
            out.append(model(*(dd[k][b:b + batch_size] for k in keys))
                       .cpu().numpy())
    return np.concatenate(out)


def _bce_train(model, data, epochs, lr, seed, batch_size, logger,
               device=None):
    """Shared BCE loop for Devign/GGNNSum over dict-of-array datasets:
    trains ``model`` in place (each epoch's mean loss left in
    ``model.losses``); returns (model, val/test metrics)."""
    from mvuld_tpu_torch.core.metrics import get_metrics_probs

    device = device or next(model.parameters()).device
    model.losses = fit_epochs(model, data["train"], GRAPH_KEYS, bce_loss,
                              epochs, lr, seed, batch_size, logger, device)
    results = {}
    for part in ("val", "test"):
        if part not in data:
            continue
        logits = _predict(model, data[part], GRAPH_KEYS, batch_size, device)
        results[part] = get_metrics_probs(data[part]["label"],
                                          1 / (1 + np.exp(-logits)))
        logger.info(f"{part}: {results[part]}")
    return model, results


def train_ivdetect(model, data, epochs, lr, seed, batch_size, logger,
                   device=None):
    """IVDetect: softmax CE (dropout off, as the JAX trainer steps it);
    eval through the softmax. Returns (model, val/test metrics); the
    epochs' mean losses in ``model.losses``."""
    from mvuld_tpu_torch.core.metrics import get_metrics_probs

    device = device or next(model.parameters()).device
    model.losses = fit_epochs(model, data["train"], IVDETECT_KEYS, ce_loss,
                              epochs, lr, seed, batch_size, logger, device)
    results = {}
    for part in ("val", "test"):
        if part not in data:
            continue
        e = np.exp(_predict(model, data[part], IVDETECT_KEYS, batch_size,
                            device))
        results[part] = get_metrics_probs(data[part]["label"],
                                          (e / e.sum(-1, keepdims=True))[:, 1])
        logger.info(f"{part}: {results[part]}")
    return model, results


def metric_step(ml, dx, dy, ia, ip, inn, keep):
    """ReVeal phase 2's loss on one batch of (anchor, positive, negative)
    indices: three passes of the learner under the same keep-masks (flax
    applies it three times with one dropout key), loss per anchor."""
    from mvuld_tpu_torch.models.baselines import reveal_loss

    logp_a, h_a = ml(dx[ia], keep)
    _, h_p = ml(dx[ip], keep)
    _, h_n = ml(dx[inn], keep)
    return reveal_loss(logp_a, h_a, dy[ia], h_p, h_n) / len(ia)


def train_reveal(ggnn, ml, data, epochs, lr, seed, batch_size, logger,
                 device=None):
    """ReVeal: phase 1 (``_bce_train`` of ``ggnn``), the graph
    representations of every split, SMOTE on train, then the metric
    learner ``ml`` (dropout masks from a generator seeded ``seed + 1``,
    drawn once per step). Returns val/test metrics of phase 2; the
    epochs' mean losses in ``ggnn.losses`` and ``ml.losses``."""
    import torch

    from mvuld_tpu_torch.core.metrics import get_metrics_probs
    from mvuld_tpu_torch.models.baselines import smote

    device = device or next(ggnn.parameters()).device
    _bce_train(ggnn, data, epochs, lr, seed, batch_size, logger, device)

    reps = {part: (_predict(lambda *a: ggnn(*a, return_repr=True)[1], d,
                            GRAPH_KEYS, batch_size, device), d["label"])
            for part, d in data.items()}

    rng_np = np.random.RandomState(seed)
    x_train, y_train = smote(*reps["train"], rng_np)
    dx = torch.as_tensor(x_train, device=device)
    dy = torch.as_tensor(y_train, device=device)
    opt = adam(ml, lr)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    pos_idx = np.where(y_train == 1)[0]
    neg_idx = np.where(y_train == 0)[0]
    ml.losses = []
    for epoch in range(epochs):
        order = rng_np.permutation(len(y_train))
        losses = []
        for b in range(max(len(y_train) // batch_size, 1)):
            idx = order[b * batch_size:(b + 1) * batch_size]
            ya = y_train[idx]
            # positive = same-class sample, negative = other-class sample
            xp_idx = np.asarray([rng_np.choice(pos_idx if y else neg_idx)
                                 for y in ya])
            xn_idx = np.asarray([rng_np.choice(neg_idx if y else pos_idx)
                                 for y in ya])
            ia, ip, inn = (torch.as_tensor(i, device=device)
                           for i in (idx, xp_idx, xn_idx))
            keep = ml.keep_masks(len(idx), gen, device)
            loss = metric_step(ml, dx, dy, ia, ip, inn, keep)
            opt.update(torch.autograd.grad(loss, opt.params))
            losses.append(loss.detach())
        ml.losses.append(float(torch.stack(losses).mean()))
        logger.info(f"[metric] epoch {epoch}: loss {ml.losses[-1]:.4f}")

    results = {}
    for part in ("val", "test"):
        if part not in reps:
            continue
        x, y = reps[part]
        with torch.no_grad():
            logp, _ = ml(torch.as_tensor(x, device=device))
        results[part] = get_metrics_probs(y, np.exp(logp.cpu().numpy())[:, 1])
        logger.info(f"{part}: {results[part]}")
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=["devign", "reveal", "ivdetect"],
                        required=True)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--hard", action="store_true",
                        help="value-binding synthetic corpus (see "
                             "tools/synthetic.py hard mode)")
    parser.add_argument("--data", default=None)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--max-nodes", type=int, default=48)
    parser.add_argument("--emb-dim", type=int, default=64)
    parser.add_argument("--out-dir", default="runs/baseline")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mvuld_tpu_torch.core.logger import create_logger
    from mvuld_tpu_torch.models.baselines import (DevignModel, GGNNSum,
                                                  IVDetect,
                                                  MetricLearningModel)
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.tools.embeddings import train_glove, train_sgns
    from mvuld_tpu_torch.train.predict import resolve_device

    device = resolve_device(args.device)
    logger = create_logger(args.out_dir)
    if args.synthetic:
        from mvuld_tpu_torch.tools.dataset import prepare_corpus
        from mvuld_tpu_torch.tools.synthetic import generate_dataset
        df = prepare_corpus(generate_dataset(args.synthetic,
                                             seed=args.seed or 42,
                                             hard=args.hard))
    else:
        import pandas as pd
        df = pd.read_pickle(args.data)

    train_corpus = df[df.label == "train"].func_before.tolist()

    def ready(model):
        init_jax_like(model, torch.Generator().manual_seed(args.seed))
        return model.to(device)

    common = dict(epochs=args.epochs, lr=args.lr, seed=args.seed,
                  batch_size=args.batch_size, logger=logger, device=device)
    if args.model == "ivdetect":
        # IVDetect uses GloVe features (reference: ivdetect via glove.py)
        emb = train_glove(train_corpus, dim=args.emb_dim, epochs=40,
                          device=device)
        data = build_ivdetect_features(df, emb, args.max_nodes)
        model, results = train_ivdetect(
            ready(IVDetect(hidden=48, feat_dim=args.emb_dim)), data, **common)
        save_baseline_ckpt(args.out_dir, {
            "model": "ivdetect", "params": model,
            "emb_vocab": emb.vocab, "emb_vectors": np.asarray(emb.vectors),
            "max_nodes": args.max_nodes, "emb_dim": args.emb_dim,
            "hidden": 48})
        return {"results": results}

    # GGNN family: word2vec features (reference: devign/dataset.py w2v+onehot)
    emb = train_sgns(train_corpus, dim=args.emb_dim, epochs=60, device=device)
    data = build_graph_features(df, emb, args.max_nodes)
    input_dim = args.emb_dim + NUM_NODE_TYPES
    width = max(input_dim, 128)

    if args.model == "devign":
        model, results = _bce_train(
            ready(DevignModel(input_dim=input_dim, output_dim=width,
                              num_steps=6, n_etypes=6)), data, **common)
        save_baseline_ckpt(args.out_dir, {
            "model": "devign", "params": model,
            "emb_vocab": emb.vocab, "emb_vectors": np.asarray(emb.vectors),
            "max_nodes": args.max_nodes, "emb_dim": args.emb_dim})
        return {"results": results}

    # reveal: phase 1 GGNNSum → reprs → SMOTE → phase 2 metric learner
    ggnn = ready(GGNNSum(output_dim=width, num_steps=8, n_etypes=6))
    ml = ready(MetricLearningModel(width, hidden_dim=128))
    results = train_reveal(ggnn, ml, data, **common)
    save_baseline_ckpt(args.out_dir, {
        "model": "reveal", "params": ggnn, "ml_params": ml,
        "emb_vocab": emb.vocab, "emb_vectors": np.asarray(emb.vectors),
        "max_nodes": args.max_nodes, "emb_dim": args.emb_dim})
    return {"results": results}


if __name__ == "__main__":
    main()
