"""Token-embedding training in PyTorch: GloVe and skip-gram word2vec.

Counterpart of ``mvuld_tpu/tools/embeddings.py`` (reference: the
StanfordNLP GloVe binaries, baselines/utils/glove.py:36-66, and gensim
Word2Vec, baselines/utils/word2vec.py:12-106). The corpus passes are host
code, copied as they are:

  * ``tokenize_code`` / ``build_vocab`` / ``cooccurrence``,
  * ``EmbeddingTable.get_embeddings`` — mean-of-token-vectors featurizer;

the two objectives run on ``device``, each step written out over the
gathered rows (gradients of repeated ids summed by ``index_add_``, atomic
on CUDA, so the card's vectors differ from the CPU's in the last bits):

  * ``glove_fit`` / ``train_glove`` — AdaGrad on the weighted
    least-squares GloVe objective over the full nonzero set, accumulator
    starting at 1, no epsilon, as the JAX package writes it,
  * ``sgns_fit`` / ``train_sgns`` — skip-gram with negative sampling, plain
    SGD on the mean loss of 8192-pair batches.

Both draw from ``np.random.RandomState(seed)`` in the JAX package's order,
so the port and JAX start from, and sample, the same numbers.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*|\d+|[^\sA-Za-z0-9_]")


def tokenize_code(text: str) -> List[str]:
    return _TOKEN_RE.findall(text)


def build_vocab(corpus: Iterable[str], min_count: int = 1,
                max_size: int = 20000) -> Dict[str, int]:
    counts = Counter()
    for doc in corpus:
        counts.update(tokenize_code(doc))
    vocab = {"<unk>": 0}
    for tok, c in counts.most_common(max_size - 1):
        if c >= min_count:
            vocab[tok] = len(vocab)
    return vocab


def cooccurrence(corpus: Iterable[str], vocab: Dict[str, int],
                 window: int = 10) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric distance-weighted cooccurrence (GloVe convention:
    increment by 1/distance). Returns (rows, cols, values)."""
    counts: Dict[Tuple[int, int], float] = defaultdict(float)
    for doc in corpus:
        ids = [vocab.get(t, 0) for t in tokenize_code(doc)]
        for i, wi in enumerate(ids):
            for d in range(1, window + 1):
                j = i + d
                if j >= len(ids):
                    break
                counts[(wi, ids[j])] += 1.0 / d
                counts[(ids[j], wi)] += 1.0 / d
    if not counts:
        return (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)
    keys = np.asarray(list(counts.keys()), np.int32)
    vals = np.asarray(list(counts.values()), np.float32)
    return keys[:, 0], keys[:, 1], vals


class EmbeddingTable:
    def __init__(self, vocab: Dict[str, int], vectors: np.ndarray):
        self.vocab = vocab
        self.vectors = np.asarray(vectors, np.float32)

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    def get_embeddings(self, text: str, seq_len: int | None = None) -> np.ndarray:
        """Mean of token vectors; with ``seq_len``, a padded [L, D] sequence
        instead (for GRU channels)."""
        ids = [self.vocab.get(t, 0) for t in tokenize_code(text)]
        if seq_len is not None:
            out = np.zeros((seq_len, self.dim), np.float32)
            for k, i in enumerate(ids[:seq_len]):
                out[k] = self.vectors[i]
            return out
        if not ids:
            return np.zeros(self.dim, np.float32)
        return self.vectors[ids].mean(axis=0)

    def most_similar(self, token: str, k: int = 5) -> List[str]:
        if token not in self.vocab:
            return []
        v = self.vectors[self.vocab[token]]
        sims = self.vectors @ v / (
            np.linalg.norm(self.vectors, axis=1) * np.linalg.norm(v) + 1e-8)
        inv = {i: t for t, i in self.vocab.items()}
        order = np.argsort(-sims)
        return [inv[i] for i in order if inv[i] != token][:k]


def _device(device):
    from mvuld_tpu_torch.train.predict import resolve_device
    return resolve_device(str(device))


def glove_fit(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, V: int,
              dim: int = 100, epochs: int = 30, lr: float = 0.05,
              x_max: float = 100.0, alpha: float = 0.75, seed: int = 0,
              device="cuda", dtype=None) -> Tuple[np.ndarray, List[float]]:
    """GloVe's vectors ``w + wc`` [V, dim] (numpy, of the compute type)
    after ``epochs`` full-batch AdaGrad steps on the nonzero set (rows,
    cols, vals), and each step's loss. The weights start as the JAX
    package's (``RandomState(seed)``: ``w``, then ``wc``, each
    uniform(−0.5, 0.5) / dim; biases 0); the accumulators start at 1 and
    p −= lr·g/√s with no epsilon. ``dtype`` (default float32) is the
    compute type."""
    import torch

    dev = _device(device)
    dtype = dtype or torch.float32
    rng = np.random.RandomState(seed)
    w = rng.uniform(-0.5, 0.5, (V, dim)) / dim
    wc = rng.uniform(-0.5, 0.5, (V, dim)) / dim

    def put(a):   # float64 draws rounded to float32 first, as JAX does
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev, dtype)

    params = [put(w), put(wc), torch.zeros(V, dtype=dtype, device=dev),
              torch.zeros(V, dtype=dtype, device=dev)]
    if len(rows) == 0:
        return params[0].cpu().numpy(), []
    r = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
    c = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
    x = put(vals)
    logx = torch.log(x)
    fx = torch.clamp((x / x_max) ** alpha, max=1.0)
    grad_sq = [torch.ones_like(p) for p in params]
    losses = []
    for _ in range(epochs):
        w, wc, b, bc = params
        wi, wj = w[r], wc[c]
        diff = (wi * wj).sum(-1) + b[r] + bc[c] - logx
        losses.append((fx * diff * diff).sum())
        g = 2.0 * fx * diff                      # ∂loss/∂pred
        grads = [torch.zeros_like(w).index_add_(0, r, g[:, None] * wj),
                 torch.zeros_like(wc).index_add_(0, c, g[:, None] * wi),
                 torch.zeros_like(b).index_add_(0, r, g),
                 torch.zeros_like(bc).index_add_(0, c, g)]
        del wi, wj
        for p, gr, s in zip(params, grads, grad_sq):
            s.add_(gr * gr)
            p.sub_(lr * gr / torch.sqrt(s))
    vectors = (params[0] + params[1]).cpu().numpy()
    return vectors, [float(v) for v in torch.stack(losses).cpu()]


def sgns_fit(pairs: np.ndarray, V: int, dim: int = 100, epochs: int = 50,
             lr: float = 0.05, negatives: int = 5, seed: int = 0,
             device="cuda", dtype=None) -> Tuple[np.ndarray, List[float]]:
    """Skip-gram's input vectors [V, dim] (numpy, of the compute type)
    after ``epochs`` SGD steps, and each step's loss. ``pairs`` [P, 2]
    (center, context); per step a batch of B = min(8192, P) pairs and
    B × ``negatives`` negatives, drawn from ``RandomState(seed)`` after the
    input vectors (randn · 0.1), in the JAX package's order."""
    import torch
    import torch.nn.functional as F

    dev = _device(device)
    dtype = dtype or torch.float32
    rng = np.random.RandomState(seed)
    w_in = torch.as_tensor(np.asarray(rng.randn(V, dim) * 0.1, np.float32)
                           ).to(dev, dtype)
    w_out = torch.zeros(V, dim, dtype=dtype, device=dev)
    pairs = np.asarray(pairs, np.int32)
    B = min(8192, len(pairs))
    losses = []
    for _ in range(epochs):
        sel = rng.randint(0, len(pairs), B)
        batch = torch.as_tensor(pairs[sel].astype(np.int64), device=dev)
        negs = torch.as_tensor(rng.randint(0, V, (B, negatives))
                               .astype(np.int64), device=dev)
        centers, contexts = batch[:, 0], batch[:, 1]
        vc, uo, un = w_in[centers], w_out[contexts], w_out[negs]
        s_pos = (vc * uo).sum(-1)                         # [B]
        s_neg = (un @ vc[..., None]).squeeze(-1)          # [B, K]
        losses.append(-(F.logsigmoid(s_pos)
                        + F.logsigmoid(-s_neg).sum(-1)).mean())
        g_pos = -torch.sigmoid(-s_pos) / B                # ∂loss/∂s_pos
        g_neg = torch.sigmoid(s_neg) / B                  # ∂loss/∂s_neg
        g_in = torch.zeros_like(w_in).index_add_(
            0, centers, g_pos[:, None] * uo + (g_neg[..., None] * un).sum(1))
        g_out = torch.zeros_like(w_out).index_add_(
            0, contexts, g_pos[:, None] * vc).index_add_(
            0, negs.reshape(-1), (g_neg[..., None] * vc[:, None]
                                  ).reshape(-1, dim))
        w_in.sub_(lr * g_in)
        w_out.sub_(lr * g_out)
    return w_in.cpu().numpy(), [float(v) for v in torch.stack(losses).cpu()]


def train_glove(corpus: Sequence[str], dim: int = 100, window: int = 10,
                epochs: int = 30, lr: float = 0.05, x_max: float = 100.0,
                alpha: float = 0.75, min_count: int = 1, seed: int = 0,
                max_vocab: int = 20000, device="cuda") -> EmbeddingTable:
    """GloVe on ``device`` via AdaGrad on the full nonzero-cooccurrence
    batch."""
    vocab = build_vocab(corpus, min_count, max_vocab)
    rows, cols, vals = cooccurrence(corpus, vocab, window)
    vectors, _ = glove_fit(rows, cols, vals, len(vocab), dim, epochs, lr,
                           x_max, alpha, seed, device)
    return EmbeddingTable(vocab, vectors)


def skipgram_pairs(corpus: Sequence[str], vocab: Dict[str, int],
                   window: int = 10) -> np.ndarray:
    """(center, context) id pairs within ``window`` tokens, [P, 2] int32."""
    pairs: List[Tuple[int, int]] = []
    for doc in corpus:
        ids = [vocab.get(t, 0) for t in tokenize_code(doc)]
        for i, wi in enumerate(ids):
            for j in range(max(0, i - window), min(len(ids), i + window + 1)):
                if j != i:
                    pairs.append((wi, ids[j]))
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def train_sgns(corpus: Sequence[str], dim: int = 100, window: int = 10,
               epochs: int = 50, lr: float = 0.05, negatives: int = 5,
               min_count: int = 1, seed: int = 0,
               max_vocab: int = 20000, device="cuda") -> EmbeddingTable:
    """Skip-gram with negative sampling (gensim Word2Vec equivalent) on
    ``device``."""
    vocab = build_vocab(corpus, min_count, max_vocab)
    V = len(vocab)
    pairs = skipgram_pairs(corpus, vocab, window)
    if not len(pairs):
        return EmbeddingTable(vocab, np.zeros((V, dim), np.float32))
    vectors, _ = sgns_fit(pairs, V, dim, epochs, lr, negatives, seed, device)
    return EmbeddingTable(vocab, vectors)
