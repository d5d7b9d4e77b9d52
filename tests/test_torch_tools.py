"""The port's host tools against the JAX package's on the same inputs, on
the CPU (``utils/oom.py``, ``tools/{joern_json,make_images,results_table,
traceparse,hardprobe,fontbench}.py``, ``data/zip_folder.py``).

- ``is_oom_shaped``: JAX's observed OOM shapes and ordinary errors give the
  same answer in both packages; the port also takes
  ``torch.cuda.OutOfMemoryError`` and the CUDA allocator's text.
- The Joern parse of ``tests/test_joern_json.py``'s fixture pair: every
  ``LineCPG`` field equal; the type buckets equal; ``run_joern`` without
  the binary returns False in both.
- ``make_images --synthetic`` into two directories: equal manifests (up to
  the directory), ``norm_pos`` pickles and ``balanced_df``, pixel-equal
  PNGs.
- The zip folder in its three cache modes, ``subset_strided_indices`` and
  ``IN22KDataset``: equal items.
- ``results_table`` on the same run directories (a harness
  ``history.json`` with and without a ``test`` entry, a baseline log, and
  a port ``train_fusion`` run): the same table.
- ``traceparse`` (its input is the port's own, so no JAX): a Chrome trace
  with known ``kernel`` events gives their sums, categories and idle
  share exactly; a real CPU profiler trace parses.
- ``hardprobe.probe_at_scale`` at n 120: the same accuracy, F1 and counts.
- ``fontbench.eval_face`` on one bundled face: the same reads.
Tolerance: exact (host code on the same inputs).
"""

import json
import os
import pickle
import zipfile

import numpy as np
import pytest
import torch

from jax_reference import (no_persistent_compile_cache,  # noqa: F401
                           one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ------------------------------------------------------------------- oom

OOM_CASES = [
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                 "allocate 17251893248 bytes."),
    RuntimeError("XLA:TPU compile permanent error. Ran out of memory "
                 "in memory space hbm. Used 17.25G of 15.75G hbm."),
    RuntimeError("INTERNAL: remote_compile: HTTP 500"),
    ValueError("flat window attention: N=783 is not a square"),
    TypeError("unsupported operand type(s)"),
    RuntimeError("INVALID_ARGUMENT: computation requires more "
                 "parameters (3) than supplied (2)"),
    KeyError("params"),
]


@pytest.mark.parametrize("exc", OOM_CASES, ids=lambda e: type(e).__name__)
def test_is_oom_shaped_matches_jax(exc):
    from mvuld_tpu.utils.oom import is_oom_shaped as jax_oom
    from mvuld_tpu_torch.utils.oom import is_oom_shaped
    assert is_oom_shaped(exc) == jax_oom(exc)


def test_is_oom_shaped_takes_cuda_errors():
    from mvuld_tpu_torch.utils.oom import is_oom_shaped
    assert is_oom_shaped(torch.cuda.OutOfMemoryError("any text"))
    assert is_oom_shaped(RuntimeError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)"))
    assert is_oom_shaped(RuntimeError(
        "CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate"))
    assert not is_oom_shaped(RuntimeError("CUDA error: illegal memory "
                                          "access"))


# ----------------------------------------------------------------- joern

def test_joern_parse_matches_jax(tmp_path):
    from test_joern_json import EDGES, NODES

    from mvuld_tpu.tools import joern_json as jj
    from mvuld_tpu_torch.tools import joern_json as pj
    base = str(tmp_path / "42.c")
    for suffix, rows in ((".nodes.json", NODES), (".edges.json", EDGES)):
        with open(base + suffix, "w") as f:
            json.dump(rows, f)
    got, want = pj.get_node_edges(base), jj.get_node_edges(base)
    assert got.nodes == want.nodes and got.edges == want.edges
    assert vars(got) == vars(want)
    for gt in ("ast", "cfg", "pdg", "all"):
        assert vars(got.filtered(gt)) == vars(want.filtered(gt))
    cases = [("CALL", "<operator>.assignment", ""),
             ("CALL", "<operator>.lessThan", ""),
             ("CALL", "<operator>.indirectIndexAccess", ""),
             ("CALL", "<operator>.logicalAnd", ""),
             ("CALL", "<operator>.cast", ""), ("CALL", "<operator>.foo", ""),
             ("CALL", "memcpy", ""), ("CALL", "my_fn", ""),
             ("CONTROL_STRUCTURE", "", "IF"), ("CONTROL_STRUCTURE", "", ""),
             ("RETURN", "", "")]
    for c in cases:
        assert pj.joern_type_to_bucket(*c) == jj.joern_type_to_bucket(*c)
    assert pj.run_joern(base, joern_bin="no-such-joern") is False
    assert jj.run_joern(base, joern_bin="no-such-joern") is False


# ----------------------------------------------------------- make_images

def test_make_images_matches_jax(tmp_path):
    import pandas as pd
    from PIL import Image

    from mvuld_tpu.tools.make_images import main as jmain
    from mvuld_tpu_torch.tools.make_images import main as pmain
    outs = {}
    for name, fn in (("jax", jmain), ("port", pmain)):
        out = str(tmp_path / name)
        outs[name] = (out, fn(["--synthetic", "24", "--out-dir", out]))
    (jo, jdf), (po, pdf) = outs["jax"], outs["port"]
    pd.testing.assert_frame_equal(pdf, jdf)
    pd.testing.assert_frame_equal(
        pd.read_pickle(os.path.join(po, "balanced_df.pkl")),
        pd.read_pickle(os.path.join(jo, "balanced_df.pkl")))
    for fname in ("train_balanced.txt", "valid.txt", "test.txt"):
        with open(os.path.join(jo, "manifests", fname)) as f:
            want = f.read().replace(jo, "OUT")
        with open(os.path.join(po, "manifests", fname)) as f:
            assert f.read().replace(po, "OUT") == want, fname
    pngs, pkls = [], []
    for root, _, files in os.walk(jo):
        for fn in files:
            rel = os.path.relpath(os.path.join(root, fn), jo)
            (pngs if fn.endswith(".png") else pkls).append(rel)
    pkls = [p for p in pkls if p.startswith("norm_pos_dict")]
    assert len(pngs) == len(jdf) and len(pkls) == len(jdf) > 4
    for rel in pngs:
        a = np.asarray(Image.open(os.path.join(jo, rel)))
        b = np.asarray(Image.open(os.path.join(po, rel)))
        np.testing.assert_array_equal(b, a, err_msg=rel)
    for rel in pkls:
        with open(os.path.join(jo, rel), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(po, rel), "rb") as f:
            assert pickle.load(f) == want, rel


# --------------------------------------------------------------- zip folder

@pytest.fixture()
def zip_dataset(tmp_path):
    from PIL import Image
    zpath = str(tmp_path / "imgs.zip")
    ann = str(tmp_path / "map.txt")
    with zipfile.ZipFile(zpath, "w") as z:
        for i in range(6):
            p = tmp_path / f"im{i}.png"
            Image.new("RGB", (8, 8), (i * 30, 7 * i, 0)).save(p)
            z.write(p, f"cls/im{i}.png")
    with open(ann, "w") as f:
        for i in range(6):
            f.write(f"cls/im{i}.png {i % 2}\n")
    return zpath, ann


@pytest.mark.parametrize("mode", ["none", "part", "full"])
def test_zip_folder_matches_jax(zip_dataset, mode):
    from mvuld_tpu.data.zip_folder import CachedZipImageFolder as J
    from mvuld_tpu_torch.data.zip_folder import CachedZipImageFolder as P
    zpath, ann = zip_dataset
    tf = np.asarray
    for rank in (0, 1):
        jd = J(zpath, ann, cache_mode=mode, rank=rank, world_size=2,
               transform=tf)
        pd_ = P(zpath, ann, cache_mode=mode, rank=rank, world_size=2,
                transform=tf)
        assert len(pd_) == len(jd) == 6
        assert sorted(pd_._cache) == sorted(jd._cache)
        for i in range(6):
            (a, la), (b, lb) = pd_[i], jd[i]
            assert la == lb and isinstance(la, int)
            np.testing.assert_array_equal(a, b)


def test_subset_strided_matches_jax():
    from mvuld_tpu.data.zip_folder import subset_strided_indices as J
    from mvuld_tpu_torch.data.zip_folder import subset_strided_indices as P
    for args in ((10, 1, 3, None), (10, 0, 4, 5), (7, 2, 2, 0)):
        np.testing.assert_array_equal(P(*args), J(*args))


def test_in22k_matches_jax(tmp_path):
    from PIL import Image

    from mvuld_tpu.data.zip_folder import IN22KDataset as J
    from mvuld_tpu_torch.data.zip_folder import IN22KDataset as P
    root = tmp_path / "in22k"
    root.mkdir()
    db = []
    for i in range(3):
        Image.new("RGB", (8, 8), (0, i * 40, 9)).save(root / f"im{i}.jpeg")
        db.append([f"im{i}.jpeg", 5000 + i])
    db.append(["missing.jpeg", 21840])          # falls back to noise
    (root / "ann.json").write_text(json.dumps(db))
    kw = dict(transform=np.asarray, target_transform=lambda t: t - 5000)
    jd, pd_ = J(str(root), "ann.json", **kw), P(str(root), "ann.json", **kw)
    assert len(pd_) == len(jd) == 4
    for i in range(4):
        np.random.seed(i)
        a, ta = pd_[i]
        np.random.seed(i)
        b, tb = jd[i]
        assert ta == tb
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- results_table

def test_results_table_matches_jax(tmp_path, capsys):
    from test_torch_fusion_zoo import CLI_OPTS, _write_cache

    from mvuld_tpu.tools.results_table import main as jmain
    from mvuld_tpu_torch.tools.results_table import main as pmain
    from mvuld_tpu_torch.train.train_fusion import main as fusion_main
    with_test = tmp_path / "a" / "x"
    with_test.mkdir(parents=True)
    (with_test / "history.json").write_text(json.dumps(
        {"test": {"f1": 0.5, "acc": 0.75, "note": "n"},
         "history": [{"f1": 0.1}]}))
    last_epoch = tmp_path / "b"
    last_epoch.mkdir()
    (last_epoch / "history.json").write_text(json.dumps(
        {"history": [{"f1": 0.2}, {"f1": 0.3, "roc_auc": 0.9}],
         "test_metrics": {"f1": 0.4}}))
    log = tmp_path / "c"
    log.mkdir()
    (log / "log_rank0.txt").write_text(
        "epoch 0: loss 0.6\ntest: {'acc': 0.5, 'f1': 0.25}\n"
        "test: {'acc': 0.625, 'f1': 0.375, 'best_f1': 0.5}\n")
    cache = str(tmp_path / "cache")
    _write_cache(cache)
    fusion = str(tmp_path / "fusion")
    fusion_main(["--cache-dir", cache, "--batch-size", "8", "--output",
                 fusion, "--device", "cpu", "--opts", *CLI_OPTS])
    specs = [f"{k}={v}" for k, v in (("a", with_test.parent),
                                    ("b", last_epoch), ("c", log),
                                    ("fusion", fusion), ("empty", ""))]
    jout = str(tmp_path / "j.json")
    pout = str(tmp_path / "p.json")
    capsys.readouterr()                  # the trainer's log lines
    want = jmain([*specs, "--json", jout])
    jtext = capsys.readouterr().out
    got = pmain([*specs, "--json", pout])
    assert capsys.readouterr().out == jtext
    assert got == want
    with open(pout) as f, open(jout) as g:
        assert json.load(f) == json.load(g)
    assert got["a"] == {"f1": 0.5, "acc": 0.75}
    assert got["b"] == {"f1": 0.3, "roc_auc": 0.9}
    assert got["c"]["f1"] == 0.375 and got["empty"] == {}
    assert "f1" in got["fusion"]


# ------------------------------------------------------------ traceparse

def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7}


def test_traceparse_known_events(tmp_path, capsys):
    from mvuld_tpu_torch.tools import traceparse as tp
    k1 = "void attn_fwd_flat<__nv_bfloat16, 32>(Geo, float*)"
    gemm = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
    ew = "void at::native::vectorized_elementwise_kernel<4, gelu>()"
    mlp_b = "void gemm_pass<DhEpi<__nv_bfloat16, true>>(Args)"
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
         "dur": 5.0, "pid": 1, "tid": 1},
        _kernel(k1, 10.0, 20.0), _kernel(k1, 40.0, 20.0),
        _kernel(gemm, 60.0, 30.0), _kernel(ew, 95.0, 5.0),
        _kernel(mlp_b, 100.0, 10.0),
        _kernel("Memcpy HtoD (Pageable -> Device)", 150.0, 10.0,
                "gpu_memcpy"),
        _kernel("Memset (Device)", 165.0, 5.0, "gpu_memset"),
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 190.0,
         "dur": 10.0, "pid": 1, "tid": 1},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5.0},
    ]
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    s = tp.summarize(tp.load_trace(path), steps=2)
    assert s["device_ms"] == pytest.approx(0.050)        # 100 µs / 2
    assert s["window_ms"] == pytest.approx(0.200)
    assert s["busy_ms"] == pytest.approx(0.100)
    assert s["idle_share"] == pytest.approx(0.5)
    assert s["events"] == 7
    cats = s["by_category"]
    assert cats["K1 window attention forward: the one pass"] == \
        pytest.approx(0.020)
    assert cats["library GEMM"] == pytest.approx(0.015)
    assert cats["elementwise"] == pytest.approx(0.0025)
    assert cats["K3b/K4b mlp_ln_bwd"] == pytest.approx(0.005)
    assert cats["other"] == pytest.approx(0.0075)        # memcpy + memset
    assert s["top"][0]["name"] == k1 and s["top"][0]["count"] == 2
    # the CLI on a trace directory: the newest json, --category, --json
    d = tmp_path / "run"
    d.mkdir()
    os.replace(path, d / "host.pt.trace.json")
    out = str(tmp_path / "s.json")
    s2 = tp.main([str(d), "--steps", "2", "--category", "library GEMM",
                  "--json", out])
    assert [r["name"] for r in s2["top"]] == [gemm]
    with open(out) as f:
        assert json.load(f)["device_ms"] == pytest.approx(0.050)
    assert "device time: 0.050 ms/step" in capsys.readouterr().out


def test_traceparse_categories_and_cpu_trace(tmp_path):
    """The categories ``chip_smoke.py`` prints (moved here unchanged), and
    a real ``torch.profiler`` trace of CPU work (no device events)."""
    from torch.profiler import ProfilerActivity, profile

    from mvuld_tpu_torch.tools import traceparse as tp
    want = {
        "attn_fwd_stats<float>": "K7/K8 window attention forward: row pass",
        "prep_forward": "K1/K7/K8 window attention forward: operand prep",
        "attn_bwd_rows": "K2/K5/K7b/K8b window attention backward passes",
        "gemm<DenseEpi<bf16, false>>": "K6 dense_fwd",
        "gemm<DenseEpi<bf16, true>>": "K6b dense_bwd",
        "gemm<HiddenEpi<bf16, false>>": "K3/K4 mlp_ln",
        "_Z4gemmI9HiddenEpiLb1EE": "K3b/K4b mlp_ln_bwd",
        "cutlass_80_tensorop": "library GEMM",
        "softmax_warp_forward": "softmax/norm/reduce",
        "index_select_kernel": "other"}
    for name, cat in want.items():
        assert tp.category(name) == cat, name
    assert tp.mlp_pass("x DxEpi y") == "dx = dhb·W1ᵀ + dz"
    assert tp.dense_pass("dense_dz_cols") == "dz, column partials"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    path = str(tmp_path / "cpu.json")
    prof.export_chrome_trace(path)
    s = tp.summarize(tp.load_trace(tp.find_trace(path)))
    assert s["events"] == 0 and s["device_ms"] == 0.0
    assert s["window_ms"] > 0 and s["idle_share"] == 1.0


# ------------------------------------------------------- hardprobe, fonts

def test_hardprobe_matches_jax():
    from mvuld_tpu.tools import hardprobe as jh
    from mvuld_tpu_torch.tools import hardprobe as ph
    for kw in (dict(hard=True), dict(hard=True, node_context=True)):
        assert ph.probe_at_scale(120, seed=7, **kw) == \
            jh.probe_at_scale(120, seed=7, **kw)
    from mvuld_tpu_torch.tools.synthetic import generate_dataset
    code = generate_dataset(2, seed=3).func_before.iloc[0]
    assert ph._node_context_text(code) == jh._node_context_text(code)


def test_fontbench_matches_jax():
    from mvuld_tpu.tools import fontbench as jf
    from mvuld_tpu_torch.tools import fontbench as pf
    assert pf._mpl_ttf("DejaVuSans.ttf") == jf._mpl_ttf("DejaVuSans.ttf")
    got = pf.eval_face("dejavu_mono", 2, seed=1)
    assert got == jf.eval_face("dejavu_mono", 2, seed=1)
    assert got["total"] > 0
