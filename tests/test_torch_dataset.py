"""The port's corpus helpers of ``tools/dataset.py`` against the JAX
package's on the same frame, on the CPU: ``remove_space_before_newline``,
``BigVulDataset`` (partition view, vulnerable-only filter, seeded sample,
stats, the functions' ``.c`` files and their paths) and ``read_manifest``
of ``write_manifests``'s files. Every result is compared exactly.
"""

import os

import pandas as pd
import pytest


@pytest.fixture(scope="module")
def corpus():
    from mvuld_tpu.tools.dataset import prepare_corpus
    from mvuld_tpu.tools.synthetic import generate_dataset
    return prepare_corpus(generate_dataset(60, seed=0))


@pytest.mark.parametrize("code", ["int f()  \n{\t\n  return 0; \n}\n",
                                  "a \t \nb\n\n  c", "no trailing"])
def test_remove_space_before_newline_matches_jax(code):
    from mvuld_tpu.tools.dataset import remove_space_before_newline as jrm
    from mvuld_tpu_torch.tools.dataset import remove_space_before_newline
    assert remove_space_before_newline(code) == jrm(code)


@pytest.mark.parametrize("kw", [dict(partition="train"),
                                dict(partition="test", vulonly=True),
                                dict(partition="train", sample=5, seed=3)],
                         ids=["train", "test_vulonly", "sample5"])
def test_bigvul_dataset_matches_jax(corpus, tmp_path, monkeypatch, kw):
    from mvuld_tpu.tools.dataset import BigVulDataset as JDataset
    from mvuld_tpu_torch.tools.dataset import BigVulDataset

    monkeypatch.setenv("MVULD_STORAGE", str(tmp_path))
    mine, ref = BigVulDataset(corpus, **kw), JDataset(corpus, **kw)
    pd.testing.assert_frame_equal(mine.df, ref.df)
    assert len(mine) == len(ref) > 0
    assert mine.stats() == ref.stats()
    if kw.get("vulonly"):
        assert (mine.df.vul == 1).all()
    _id = int(mine.df._id.iloc[0])
    assert mine.itempath(_id) == ref.itempath(_id)
    head = BigVulDataset(corpus.head(3), partition="train",
                         func_dir=str(tmp_path / "funcs"))
    head.write_functions()
    for _, row in head.df.iterrows():
        with open(head.itempath(int(row._id))) as f:
            assert f.read() == row.func_before


def test_read_manifest_matches_jax(corpus, tmp_path):
    from mvuld_tpu.tools.dataset import read_manifest as jread
    from mvuld_tpu_torch.tools.dataset import read_manifest, write_manifests

    paths = write_manifests(corpus, img_dir="imgs", out_dir=str(tmp_path))
    for p in paths:
        assert os.path.getsize(p) > 0
        got = read_manifest(p)
        pd.testing.assert_frame_equal(got, jread(p))
        assert set(got.columns) == {"_id", "img_path", "vul"}
