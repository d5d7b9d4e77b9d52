"""The port's corpus tools against the JAX package's, on the CPU.

- ``tools/embeddings.py``: ``tokenize_code``, ``build_vocab``,
  ``cooccurrence`` and ``EmbeddingTable`` exactly; ``train_glove`` and
  ``train_sgns`` vectors after a few epochs within 1e-4 (the same
  ``RandomState`` draws; fp32 sums in other orders), and their
  displacement from the shared start within 1e-4 of JAX's, which is made
  to be many times that tolerance (SGNS at its default rate moves its
  vectors by under 1e-5 in a few epochs, so it runs at a larger one);
  fp64 ``glove_fit`` held against fp32.
- ``tools/gitdiff.py`` and ``tools/mutate.py`` exactly (every mutation,
  ``mutate``, ``augment_dataframe``).
- ``process_dataset --glove --w2v --device cpu`` against the JAX CLI: the
  same cleaned pickle and ``embeddings/{glove,w2v}.npz``.
"""

import functools

import random

import numpy as np
import pandas as pd
import pytest
import torch

from mvuld_tpu.tools import embeddings as je
from mvuld_tpu.tools import gitdiff as jg
from mvuld_tpu.tools import mutate as jmu
from mvuld_tpu_torch.tools import embeddings as pe
from mvuld_tpu_torch.tools import gitdiff as pg
from mvuld_tpu_torch.tools import mutate as pmu
from mvuld_tpu_torch.tools.synthetic import generate_function, hard_twin
from jax_reference import (no_persistent_compile_cache,  # noqa: F401
                           one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TOL = dict(atol=1e-4, rtol=1e-4)


def _glove_init(V, dim, seed):
    rng = np.random.RandomState(seed)
    w = (rng.uniform(-0.5, 0.5, (V, dim)) / dim).astype(np.float32)
    return w + (rng.uniform(-0.5, 0.5, (V, dim)) / dim).astype(np.float32)


def _sgns_init(V, dim, seed):
    return (np.random.RandomState(seed).randn(V, dim) * 0.1).astype(np.float32)


def _assert_same_update(got, want, init):
    """``got`` agrees with ``want`` and so does its displacement from the
    shared ``init``, which is many times the tolerance: what is compared is
    the update, not the start both sides draw alike."""
    moved = want - init
    assert np.abs(moved).max() > 1000 * TOL["atol"]
    np.testing.assert_allclose(got, want, **TOL)
    assert (np.linalg.norm(got - init - moved)
            <= TOL["rtol"] * np.linalg.norm(moved))


def _corpus(n=24, seed=3):
    rng = random.Random(seed)
    return [generate_function(rng, hard=i % 2 == 1)[0] for i in range(n)]


def test_corpus_passes_are_exact():
    corpus = _corpus()
    for doc in corpus[:4]:
        assert pe.tokenize_code(doc) == je.tokenize_code(doc)
    for kw in (dict(), dict(min_count=2), dict(max_size=30)):
        assert pe.build_vocab(corpus, **kw) == je.build_vocab(corpus, **kw)
    vocab = je.build_vocab(corpus, max_size=40)
    for window in (1, 10):
        for got, want in zip(pe.cooccurrence(corpus, vocab, window),
                             je.cooccurrence(corpus, vocab, window)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    empty = pe.cooccurrence([""], vocab)
    for got, want in zip(empty, je.cooccurrence([""], vocab)):
        assert got.shape == want.shape and got.dtype == want.dtype


def test_embedding_table_is_exact():
    corpus = _corpus()
    vocab = je.build_vocab(corpus)
    vec = np.random.RandomState(0).randn(len(vocab), 6).astype(np.float32)
    jt, pt = je.EmbeddingTable(vocab, vec), pe.EmbeddingTable(vocab, vec)
    line = corpus[0].split("\n")[2]
    for kw in (dict(), dict(seq_len=4), dict(seq_len=40)):
        np.testing.assert_array_equal(pt.get_embeddings(line, **kw),
                                      jt.get_embeddings(line, **kw))
    np.testing.assert_array_equal(pt.get_embeddings(""),
                                  jt.get_embeddings(""))
    tok = next(iter(vocab))
    assert pt.most_similar(tok) == jt.most_similar(tok)
    assert pt.most_similar("not a token") == []


def test_train_glove_matches_jax():
    corpus = _corpus()
    kw = dict(dim=12, window=4, epochs=6, seed=2, max_vocab=60)
    want = je.train_glove(corpus, **kw)
    got = pe.train_glove(corpus, device="cpu", **kw)
    assert got.vocab == want.vocab
    _assert_same_update(got.vectors, want.vectors,
                        _glove_init(len(want.vocab), 12, 2))


def test_glove_fit_fp64_against_fp32():
    """The same run in fp64 and fp32: repeated row ids accumulate their
    gradients in either type."""
    corpus = _corpus()
    vocab = pe.build_vocab(corpus, max_size=60)
    rows, cols, vals = pe.cooccurrence(corpus, vocab, 4)
    assert len(np.unique(rows)) < len(rows)          # repeated ids
    v64, l64 = pe.glove_fit(rows, cols, vals, len(vocab), 12, 6, seed=2,
                            device="cpu", dtype=torch.float64)
    v32, l32 = pe.glove_fit(rows, cols, vals, len(vocab), 12, 6, seed=2,
                            device="cpu")
    np.testing.assert_allclose(v32, v64, **TOL)
    np.testing.assert_allclose(l32, l64, rtol=1e-5)
    assert l64[-1] < l64[0]


def test_train_sgns_matches_jax():
    corpus = _corpus()
    kw = dict(dim=12, window=3, epochs=5, negatives=3, seed=4, max_vocab=60,
              lr=20.0)
    want = je.train_sgns(corpus, **kw)
    got = pe.train_sgns(corpus, device="cpu", **kw)
    assert got.vocab == want.vocab
    _assert_same_update(got.vectors, want.vectors,
                        _sgns_init(len(want.vocab), 12, 4))
    # no pairs: zero vectors on both sides
    one = ["x"]
    np.testing.assert_array_equal(
        pe.train_sgns(one, dim=4, device="cpu").vectors,
        je.train_sgns(one, dim=4).vectors)


def _twins(n=12, seed=5):
    rng = random.Random(seed)
    return [hard_twin(rng) for _ in range(n)]


def test_gitdiff_is_exact():
    for before, after in _twins():
        assert pg.gitdiff(before, after) == jg.gitdiff(before, after)
        assert pg.code2diff(before, after) == jg.code2diff(before, after)
    twins = _twins(4)
    df = pd.DataFrame({"func_before": [t[0] for t in twins],
                       "func_after": [twins[0][0], twins[1][1], None,
                                      twins[3][1]]})
    pd.testing.assert_frame_equal(pg.mark_vulnerable_lines(df),
                                  jg.mark_vulnerable_lines(df))


def test_mutations_are_exact():
    assert list(pmu.MUTATIONS) == list(jmu.MUTATIONS)
    for i, code in enumerate(_corpus(16)):
        for name in jmu.MUTATIONS:
            assert (pmu.MUTATIONS[name](code, random.Random(i))
                    == jmu.MUTATIONS[name](code, random.Random(i))), name
        assert pmu.mutate(code, seed=i) == jmu.mutate(code, seed=i)
    df = pd.DataFrame({"_id": [1, 2, 3], "func_before": _corpus(3),
                       "vul": [0, 1, 0], "label": ["train"] * 3})
    pd.testing.assert_frame_equal(pmu.augment_dataframe(df, seed=2),
                                  jmu.augment_dataframe(df, seed=2))


def test_process_dataset_matches_jax(tmp_path, monkeypatch):
    """``--glove --w2v`` with the corpus funnel and augmentation: the same
    cleaned pickle, vocabularies and vectors (1e-4) as the JAX CLI, and the
    same displacement from the start. Both CLIs' SGNS runs at rate 2 (the
    CLI has no flag for it): at its default 0.05 the vectors move by under
    1e-3, too little for 1e-4 to tell a right update from a wrong one."""
    from mvuld_tpu.tools.process_dataset import main as jax_main
    from mvuld_tpu_torch.tools.process_dataset import main as port_main

    for mod in (je, pe):
        monkeypatch.setattr(mod, "train_sgns",
                            functools.partial(mod.train_sgns, lr=2.0))

    argv = ["--synthetic", "40", "--augment", "--glove", "--w2v",
            "--emb-dim", "8"]
    want = jax_main(argv + ["--output", str(tmp_path / "jax" / "c.pkl")])
    got = port_main(argv + ["--output", str(tmp_path / "port" / "c.pkl"),
                            "--device", "cpu"])
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(pd.read_pickle(tmp_path / "port" / "c.pkl"),
                                  want)
    for name, init in (("glove", _glove_init), ("w2v", _sgns_init)):
        with np.load(tmp_path / "jax" / "embeddings" / f"{name}.npz") as j, \
                np.load(tmp_path / "port" / "embeddings" / f"{name}.npz") as p:
            assert set(p.files) == set(j.files) == {"vectors", "vocab"}
            np.testing.assert_array_equal(p["vocab"], j["vocab"])
            _assert_same_update(p["vectors"], j["vectors"],
                                init(len(j["vocab"]), 8, 0))


@pytest.mark.parametrize("fn", ["train_glove", "train_sgns"])
def test_cuda_without_a_card_raises(fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(pe, fn)(_corpus(2), dim=4, epochs=1)
