"""Offline feature caches for the fusion trainer (counterpart of
``mvuld_tpu/train/precompute.py``).

The reference stages its tri-modal pipeline through disk caches
(cache_swin_features data_list.py:179-211, cache_g_items/item() 265-317,
unixcoder result.pkl): the fusion trainer then reads only cached arrays.
One consolidated npz per partition:

  {part}.npz:
    img_emb   [N, 1024]   SwinV2 forward_features of the rendered graph PNG
    text_emb  [N, 768]    UniXcoder sentence embedding of the function
    node_emb  [N, M, 768] UniXcoder per-line embeddings (M = MAX_NODES)
    token_ids [N, M, Tn]  the per-line token ids
    pos       [N, M, 4]   normalized node bboxes (+ 2k numeric features with
                          DATA.NODE_NUMERIC = k)
    adj       [N, M, M]   uint8 edge-type bitmask adjacency
    node_mask [N, M], lineno [N, M], ntype [N, M]
    label     [N], ids [N]

Every stage is idempotent: images, positions and npz files are only built if
absent. ``encode_cache_columns`` is the encoder half over arrays (token ids,
images): ``build_fusion_cache`` calls it after the host work (render, pack,
tokenize), and a caller that already holds the arrays calls it alone, with
no pandas or PIL. ``frozen_text_encoder`` / ``frozen_swin_encoder`` wrap the
port's modules as the ids→embedding / images→embedding callables it takes.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np


def _render_one(item: Dict, img_dir: str, pos_dir: str, gtype: str):
    """Render a single function (module-level so dfmp can pickle it)."""
    from mvuld_tpu_torch.tools.cpg import extract_line_cpg
    from mvuld_tpu_torch.tools.render import render_cpg, save_norm_pos

    _id = int(item["_id"])
    img_path = os.path.join(img_dir, f"{_id}.png")
    pos_path = os.path.join(pos_dir, f"{_id}.pkl")
    if os.path.exists(img_path) and os.path.exists(pos_path):
        return (_id, img_path)
    cpg = extract_line_cpg(item["func_before"])
    if cpg is None:
        return None
    g = cpg.filtered(gtype)
    if len(g.nodes) < 2:
        return None
    _img, pos = render_cpg(g, out_path=img_path)
    save_norm_pos(pos, pos_path)
    return (_id, img_path)


def render_corpus(df, img_dir: str, pos_dir: str, gtype: str = "all",
                  logger=None, workers: int = 6) -> Dict[int, str]:
    """Render every function's CPG to PNG + norm-pos pickle (idempotent),
    dfmp-parallel over rows. Returns {_id: img_path}; unparseable functions
    are dropped."""
    import functools

    from mvuld_tpu_torch.tools.storage import dfmp

    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pos_dir, exist_ok=True)
    fn = functools.partial(_render_one, img_dir=img_dir, pos_dir=pos_dir,
                           gtype=gtype)
    results = dfmp(df, fn, columns=["_id", "func_before"], workers=workers)
    paths = dict(r for r in results if r)
    if logger:
        logger.info(f"rendered {len(paths)}/{len(df)} graphs → {img_dir}")
    return paths


def _pack_one(item: Dict, pos_dir: str, gtype: str, max_nodes: int):
    """Extract + pack one function's graph (module-level for dfmp)."""
    from mvuld_tpu_torch.data.graph_batch import pack_graph
    from mvuld_tpu_torch.tools.cpg import extract_line_cpg
    from mvuld_tpu_torch.tools.render import load_norm_pos

    _id = int(item["_id"])
    cpg = extract_line_cpg(item["func_before"])
    pos_dict = load_norm_pos(os.path.join(pos_dir, f"{_id}.pkl"))
    return pack_graph(cpg, max_nodes, pos_dict=pos_dict, gtype=gtype)


def empty_cache_columns(n: int, cfg) -> Dict[str, np.ndarray]:
    """Zeroed feature and graph columns of an ``n``-row partition (``label``
    and ``ids`` are the caller's)."""
    M = cfg.DATA.MAX_NODES
    text_dim, img_dim = cfg.MODEL.MULTI.TEXT_DIM, cfg.MODEL.MULTI.IMG_DIM
    pos_dim = 4 + 2 * int(cfg.DATA.NODE_NUMERIC)
    return {
        "img_emb": np.zeros((n, img_dim), np.float32),
        "text_emb": np.zeros((n, text_dim), np.float32),
        "node_emb": np.zeros((n, M, text_dim), np.float32),
        "pos": np.zeros((n, M, pos_dim), np.float32),
        "adj": np.zeros((n, M, M), np.uint8),
        "node_mask": np.zeros((n, M), np.float32),
        "lineno": np.zeros((n, M), np.int32),
        "ntype": np.zeros((n, M), np.int32),
        # per-node token ids — the reference's tokenized graph-cache variant
        # (item1, data_list.py:235-263)
        "token_ids": np.zeros((n, M, cfg.DATA.NODE_TOKENS), np.int32),
    }


def encode_cache_columns(arrs: Dict[str, np.ndarray], *,
                         func_ids: Optional[np.ndarray] = None,
                         line_ids: Optional[np.ndarray] = None,
                         line_index: Optional[np.ndarray] = None,
                         images=None,
                         text_encoder: Optional[Callable] = None,
                         swin_encoder: Optional[Callable] = None,
                         encode_batch: int = 32) -> None:
    """The encoder half of the cache, over arrays, in place in ``arrs``:

      func_ids [n, T]            → text_emb through ``text_encoder``
      line_ids [L, Tn] with line_index [L, 2] = (row, node)
                                 → token_ids, and node_emb through
                                   ``text_encoder``
      images [n, S, S, 3], or a callable (lo, hi) → that slice
                                 → img_emb through ``swin_encoder``

    ``encode_batch`` rows per encoder call. A missing encoder leaves its
    columns as they are."""
    if func_ids is not None and text_encoder is not None:
        for lo in range(0, len(func_ids), encode_batch):
            chunk = np.asarray(func_ids[lo:lo + encode_batch])
            arrs["text_emb"][lo:lo + len(chunk)] = text_encoder(chunk)
    if line_ids is not None:
        rows, nodes = np.asarray(line_index).reshape(-1, 2).T
        arrs["token_ids"][rows, nodes] = line_ids
        if text_encoder is not None:
            for lo in range(0, len(line_ids), encode_batch):
                chunk = np.asarray(line_ids[lo:lo + encode_batch])
                hi = lo + len(chunk)
                arrs["node_emb"][rows[lo:hi], nodes[lo:hi]] = \
                    text_encoder(chunk)
    if images is not None and swin_encoder is not None:
        n = len(arrs["img_emb"])
        for lo in range(0, n, encode_batch):
            hi = min(lo + encode_batch, n)
            imgs = images(lo, hi) if callable(images) else images[lo:hi]
            arrs["img_emb"][lo:hi] = swin_encoder(np.asarray(imgs))


def build_fusion_cache(df, cache_dir: str, cfg, *, text_encoder=None,
                       swin_encoder=None, tokenizer=None, logger=None,
                       workers: int = 6, encode_batch: int = 32,
                       pos_dir: str = None) -> Dict[str, str]:
    """Build {part}.npz caches for all partitions present in ``df``.

    ``text_encoder`` / ``swin_encoder``: callables ids→emb / images→emb
    (``make_random_encoders`` gives frozen random ones for runs without
    trained checkpoints). Graph extraction and packing run under dfmp;
    encoder calls take ``encode_batch`` rows at a time. ``pos_dir`` points
    node positions at other boxes than the renderer's oracle ones."""
    import functools

    from mvuld_tpu_torch.data.tokenizer import normalize_line
    from mvuld_tpu_torch.data.transforms import load_image, resize_normalize
    from mvuld_tpu_torch.tools.storage import dfmp

    os.makedirs(cache_dir, exist_ok=True)
    img_dir = os.path.join(cache_dir, "imgs")
    oracle_pos_dir = os.path.join(cache_dir, "pos")
    paths = render_corpus(df, img_dir, oracle_pos_dir, cfg.DATA.GTYPE, logger,
                          workers=workers)
    pos_dir = pos_dir or oracle_pos_dir

    M = cfg.DATA.MAX_NODES
    out_paths = {}
    for part in sorted(df.label.unique()):
        npz_path = os.path.join(cache_dir, f"{part}.npz")
        out_paths[part] = npz_path
        if os.path.exists(npz_path):
            continue
        rows = df[df.label == part]
        rows = rows[rows._id.isin(paths)]
        n = len(rows)
        arrs = empty_cache_columns(n, cfg)
        arrs["label"] = rows.vul.to_numpy().astype(np.int32)
        arrs["ids"] = rows._id.to_numpy().astype(np.int64)

        # --- graph extraction + packing, dfmp-parallel over rows
        pack = functools.partial(_pack_one, pos_dir=pos_dir,
                                 gtype=cfg.DATA.GTYPE, max_nodes=M)
        packed = dfmp(rows, pack, columns=["_id", "func_before"],
                      workers=workers)
        funcs = rows.func_before.tolist()
        for i, pg in enumerate(packed):
            if pg is None:      # per-item failure swallowed by dfmp
                continue
            arrs["pos"][i, :, :4] = pg.pos
            arrs["adj"][i] = pg.adj
            arrs["node_mask"][i] = pg.mask
            arrs["lineno"][i] = pg.lineno
            arrs["ntype"][i] = pg.ntype
            if cfg.DATA.NODE_NUMERIC:
                from mvuld_tpu_torch.tools.cpg import (extract_line_cpg,
                                                       numeric_literal_feats)
                cpg = extract_line_cpg(funcs[i])
                if cpg is not None:
                    arrs["pos"][i, : pg.num_nodes, 4:] = numeric_literal_feats(
                        cpg, pg.lineno[: pg.num_nodes], funcs[i].split("\n"),
                        k=int(cfg.DATA.NODE_NUMERIC))

        func_ids = line_ids = line_index = None
        if tokenizer is not None:
            if text_encoder is not None and n:
                func_ids = np.asarray(tokenizer.tokenize(
                    funcs, max_length=cfg.DATA.FUNC_TOKENS))
            # per-line node texts (myEncode, data_list.py:292-299): all
            # (row, node) lines of the partition, flattened
            flat_lines, flat_idx = [], []
            for i, pg in enumerate(packed):
                if pg is None:
                    continue
                lines = funcs[i].split("\n")
                lns = pg.lineno[: pg.num_nodes]
                if cfg.DATA.NODE_CONTEXT == "deps":
                    # dependency-context node text (cpg.dep_context_lines)
                    from mvuld_tpu_torch.tools.cpg import (dep_context_lines,
                                                           extract_line_cpg)
                    cpg = extract_line_cpg(funcs[i])
                    texts = [normalize_line(s)
                             for s in dep_context_lines(cpg, lns, lines)]
                else:
                    texts = [normalize_line(lines[ln - 1])
                             if 1 <= ln <= len(lines) else "" for ln in lns]
                flat_lines.extend(texts)
                flat_idx.extend((i, j) for j in range(len(texts)))
            if flat_lines:
                line_ids = np.asarray(tokenizer.tokenize(
                    flat_lines, max_length=cfg.DATA.NODE_TOKENS))
                line_index = np.asarray(flat_idx, np.int64)

        ids = rows._id.tolist()

        def images(lo, hi):
            return np.stack([resize_normalize(load_image(paths[int(_id)]),
                                              cfg.DATA.IMG_SIZE)
                             for _id in ids[lo:hi]])

        encode_cache_columns(arrs, func_ids=func_ids, line_ids=line_ids,
                             line_index=line_index,
                             images=images if n else None,
                             text_encoder=text_encoder,
                             swin_encoder=swin_encoder,
                             encode_batch=encode_batch)
        np.savez_compressed(npz_path, **arrs)
        if logger:
            logger.info(f"cached {n} items → {npz_path}")
    return out_paths


def make_random_encoders(cfg, seed: int = 0):
    """Frozen random-projection 'encoders' for cache building without trained
    checkpoints: deterministic hash-like features so the graph/pos modality
    remains informative in tests."""
    rng = np.random.RandomState(seed)
    text_dim = cfg.MODEL.MULTI.TEXT_DIM
    img_dim = cfg.MODEL.MULTI.IMG_DIM
    Wt = rng.randn(4096, text_dim).astype(np.float32) / 64.0

    def text_encoder(ids: np.ndarray) -> np.ndarray:
        # bag-of-token-hash projection
        out = np.zeros((ids.shape[0], text_dim), np.float32)
        for i, row in enumerate(np.asarray(ids)):
            toks = row[row > 2]
            if len(toks):
                out[i] = Wt[toks % 4096].mean(axis=0)
        return out

    Wi = rng.randn(64 * 64 * 3, img_dim).astype(np.float32) / 128.0

    def swin_encoder(imgs: np.ndarray) -> np.ndarray:
        import cv2
        out = np.zeros((imgs.shape[0], img_dim), np.float32)
        for i, im in enumerate(np.asarray(imgs)):
            small = cv2.resize(im, (64, 64)).reshape(-1)
            out[i] = small @ Wi
        return out

    return text_encoder, swin_encoder


def frozen_text_encoder(embedder, device) -> Callable[[np.ndarray], np.ndarray]:
    """``embedder`` (a ``UniXcoderEmbedder`` or classifier) in eval mode on
    ``device`` as ids [k, T] → fp32 sentence embeddings [k, H]."""
    import torch

    embedder.to(device).eval()

    def encode(ids: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(ids, np.int64), device=device)
            _first, sent = embedder(x)       # both return the sentence second
            return sent.float().cpu().numpy()

    return encode


def frozen_swin_encoder(swin, device) -> Callable[[np.ndarray], np.ndarray]:
    """``swin`` (``SwinTransformerV2``) in eval mode on ``device`` as images
    [k, S, S, 3] → fp32 pooled features [k, num_features]
    (``return_features``: the head, if any, is not applied)."""
    import torch

    swin.to(device).eval()

    def encode(imgs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(imgs, np.float32), device=device)
            return swin(x, return_features=True).float().cpu().numpy()

    return encode
