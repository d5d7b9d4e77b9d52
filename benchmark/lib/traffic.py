"""The one traffic generator: a cell's parameters and a seed → host arrays.

Rows are featurised functions in the layout the trainer's cache and the
serving CLI's ``build_request`` produce: UniXcoder framing of the function
and of each code line ([<s>, <encoder-only>, </s>] body </s>, pad id 1),
token ids Zipf-distributed over the vocabulary, valid code lines with
normalised boxes, an adjacency of edge-type bits among the valid lines
(self-loops on every type), a rendered image drawn normal (rounded to
bf16, carried as fp32 as the cache carries images) and a 0/1 label.

Parameters (a cell's "traffic"): ``lines`` [lo, hi] valid lines per
function; ``func_tokens`` and ``line_tokens`` "fill" or [lo, hi] real
tokens; ``zipf`` the exponent; ``edge_types``, ``edge_density``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

BOS = (0, 5, 2)     # <s> <encoder-only> </s>
EOS, PAD = 2, 1
FIRST_ID = 9        # ids below are special tokens


def _ids(rng, shape, vocab: int, a: float) -> np.ndarray:
    z = rng.zipf(a, size=shape)
    return (FIRST_ID + (z - 1) % (vocab - FIRST_ID)).astype(np.int32)


def _framed(rng, n: int, width: int, lengths: np.ndarray, vocab: int,
            a: float) -> np.ndarray:
    """[n, width] ids: framing around ``lengths`` body tokens, then pads."""
    body = _ids(rng, (n, width), vocab, a)
    pos = np.arange(width)[None]
    L = lengths[:, None]
    out = np.where(pos < 3, np.asarray(BOS + (0,) * (width - 3))[None, :width],
                   body)
    out = np.where(pos == L + 3, EOS, out)
    out = np.where(pos > L + 3, PAD, out)
    return out.astype(np.int32)


def _lengths(rng, spec, n: int, width: int) -> np.ndarray:
    if spec == "fill":
        return np.full(n, width - 4)
    lo, hi = spec
    return rng.integers(lo, hi + 1, n)


def images(n: int, size: int, seed: int, device) -> np.ndarray:
    """[n, size, size, 3] fp32 host images, normal draws rounded to bf16,
    made on ``device`` from ``seed``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, size, size, 3), generator=gen, device=device)
    return x.to(torch.bfloat16).float().cpu().numpy()


def rows(p: Dict, dims: Dict, n: int, seed: int, device) -> Dict[str, np.ndarray]:
    """``n`` featurised rows. ``dims``: max_nodes, func_tokens,
    node_tokens, img_size, vocab."""
    rng = np.random.default_rng(seed)
    M, T, Tn = dims["max_nodes"], dims["func_tokens"], dims["node_tokens"]
    V, a = dims["vocab"], p["zipf"]
    lo, hi = p["lines"]
    nvalid = rng.integers(lo, hi + 1, n)
    node_mask = (np.arange(M)[None] < nvalid[:, None]).astype(np.float32)
    func = _framed(rng, n, T, _lengths(rng, p["func_tokens"], n, T), V, a)
    lines = _framed(rng, n * M, Tn, _lengths(rng, p["line_tokens"], n * M, Tn),
                    V, a).reshape(n, M, Tn)
    lines[node_mask == 0] = PAD
    x0 = rng.random((n, M, 2), dtype=np.float32) * 0.5
    pos = np.concatenate([x0, x0 + 0.05], -1) * node_mask[..., None]
    bits = (1 << rng.integers(0, p["edge_types"], (n, M, M))).astype(np.uint8)
    adj = np.where(rng.random((n, M, M)) < p["edge_density"], bits, 0)
    both = node_mask[:, :, None] * node_mask[:, None, :] > 0
    adj = np.where(both, adj, 0).astype(np.uint8)
    eye = np.eye(M, dtype=bool)[None] & both
    adj[eye] |= np.uint8((1 << p["edge_types"]) - 1)
    return {"func_ids": func, "node_ids": lines.astype(np.int32),
            "image": images(n, dims["img_size"], int(rng.integers(2 ** 31)),
                            device),
            "pos": pos.astype(np.float32), "adj": adj, "node_mask": node_mask,
            "label": rng.integers(0, 2, n).astype(np.int32)}


def batches(p: Dict, dims: Dict, count: int, batch: int, seed: int, device
            ) -> List[Dict[str, np.ndarray]]:
    """``count`` batches of ``batch`` distinct rows."""
    r = rows(p, dims, count * batch, seed, device)
    return [{k: v[i * batch:(i + 1) * batch] for k, v in r.items()}
            for i in range(count)]


def image_batches(count: int, batch: int, size: int, seed: int, device
                  ) -> List[Dict[str, np.ndarray]]:
    """``count`` batches of normal images and 0/1 labels."""
    rng = np.random.default_rng(seed)
    x = images(count * batch, size, int(rng.integers(2 ** 31)), device)
    y = rng.integers(0, 2, count * batch).astype(np.int32)
    return [{"image": x[i * batch:(i + 1) * batch],
             "label": y[i * batch:(i + 1) * batch]} for i in range(count)]


def request_sizes(p: Dict, seed: int, count: int) -> List[int]:
    """``count`` request sizes: blocks of ``p["block"]`` requests, each the
    same multiset (each kind's share of the block, its sizes spread evenly
    over its range), in an order drawn from ``seed``."""
    unit: List[int] = []
    for kind in p["kinds"]:
        k = int(round(kind["share"] * p["block"]))
        lo, hi = kind["range"]
        unit += [int(round(v)) for v in np.linspace(lo, hi, k)]
    rng = np.random.default_rng(seed)
    out: List[int] = []
    while len(out) < count:
        out += [unit[i] for i in rng.permutation(len(unit))]
    return out[:count]


def requests(p: Dict, pool: int, seed: int, count: int
             ) -> List[Tuple[int, int]]:
    """(first row, rows) of ``count`` requests over a pool of ``pool``
    rows: contiguous runs, so a request's arrays are views."""
    sizes = request_sizes(p, seed, count)
    rng = np.random.default_rng(seed + 1)
    return [(int(rng.integers(0, pool - n + 1)), n) for n in sizes]
