"""The port's serving CLI against the JAX one, on the CPU.

A fake finished JAX run dir (saved config + tokenizer + best-F1 orbax
checkpoint of a tiny model, as tests/test_predict.py builds it) also gets
``variables.npz``: the same variables flattened with '/' keys, which is
what the port reads. Both CLIs run on the same .c sources at fp32 with the
plain layers (the JAX CLI's CPU path; the port's ``--device cpu``).

``--east-ckpt`` (EAST detection + line-number recognition) runs both CLIs
with one stand-in detector and compares the OCR positions and P(vul).

A run trained by the port's own ``train_e2e`` CLI holds port checkpoints
and no ``variables.npz``: ``predict --run-dir`` serves its best-F1
checkpoint, with the P(vul) of that checkpoint restored by hand.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
from jax_reference import no_persistent_compile_cache  # noqa: F401

C1 = """int foo(int a) {
  int b = a + 1;
  if (b > 2) {
    b = b * 2;
  }
  return b;
}
"""

C2 = """void bar(char *dst, char *src) {
  strcpy(dst, src);
  int n = strlen(dst);
  if (n > 10) {
    n = 0;
  }
  memcpy(dst, src, n);
}
"""

C3 = C1.replace("foo", "baz").replace("b * 2", "b * 3 - a")

TOY_OPTS = [
    "MODEL.UNIXCODER.LAYERS", "1", "MODEL.UNIXCODER.HIDDEN", "32",
    "MODEL.UNIXCODER.HEADS", "2", "MODEL.UNIXCODER.INTERMEDIATE", "64",
    "MODEL.SWINV2.EMBED_DIM", "16", "MODEL.SWINV2.DEPTHS", "[2, 2]",
    "MODEL.SWINV2.NUM_HEADS", "[2, 2]", "MODEL.SWINV2.WINDOW_SIZE", "4",
    "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", "[0, 0]",
    "DATA.IMG_SIZE", "32", "DATA.FUNC_TOKENS", "64", "DATA.NODE_TOKENS", "16",
    "DATA.MAX_NODES", "16", "MODEL.MULTI.HIDDEN", "64",
    "MODEL.MULTI.NUM_RS_GCN", "1", "MODEL.MULTI.NUM_HIDDEN_FC", "1",
    "PARALLEL.DTYPE", "float32",
]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A finished train_e2e run dir; the variables are perturbed from init
    with a numpy seed so P(vul) differs across functions, and land both in
    the orbax checkpoint (JAX) and in variables.npz (port)."""
    import jax
    import jax.numpy as jnp

    from mvuld_tpu.config import get_config, save_config
    from mvuld_tpu.core.checkpoint import save_checkpoint
    from mvuld_tpu.data.tokenizer import CodeTokenizer
    from mvuld_tpu.train.train_e2e import build_e2e_model
    from mvuld_tpu_torch.models.convert import flatten_variables

    out = str(tmp_path_factory.mktemp("e2e_run"))
    cfg = get_config(SimpleNamespace(cfg=None, opts=TOY_OPTS, output=out))
    run = cfg.OUTPUT
    os.makedirs(run, exist_ok=True)
    save_config(cfg, run)
    tok = CodeTokenizer.train([C1, C2], vocab_size=256)
    tok.save(os.path.join(run, "tokenizer.json"))

    model, _, _ = build_e2e_model(cfg, tok.vocab_size, scan_blocks=True)
    M, T, Tn = cfg.DATA.MAX_NODES, cfg.DATA.FUNC_TOKENS, cfg.DATA.NODE_TOKENS
    S = cfg.DATA.IMG_SIZE
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(0),
        func_ids=jnp.zeros((1, T), jnp.int32),
        node_ids=jnp.zeros((1, M, Tn), jnp.int32),
        image=jnp.zeros((1, S, S, 3), jnp.float32),
        pos=jnp.zeros((1, M, 4), jnp.float32),
        adj=jnp.zeros((1, M, M), bool),
        node_mask=jnp.ones((1, M), jnp.float32), train=False))
    rng = np.random.RandomState(0)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    save_checkpoint(run, 0, {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "step": 0, "epoch": 0, "best_f1": 0.0}, best=True)
    np.savez(os.path.join(run, "variables.npz"),
             **flatten_variables(variables))
    return out


def _write_sources(d, named):
    paths = []
    for name, code in named:
        p = os.path.join(str(d), f"{name}.c")
        with open(p, "w") as f:
            f.write(code)
        paths.append(p)
    return paths


def test_export_recipe_matches_variables_npz(run_dir):
    """The README's export recipe (orbax checkpoint → flattened .npz) gives
    the variables the port serves from."""
    from mvuld_tpu.core.checkpoint import (auto_resume_helper,
                                           load_checkpoint,
                                           resume_bestf1_helper)
    from mvuld_tpu.train.predict import _resolve_run_dir
    from mvuld_tpu_torch.models.convert import flatten_variables

    run = _resolve_run_dir(run_dir)
    state = load_checkpoint(resume_bestf1_helper(run) or auto_resume_helper(run))
    flat = flatten_variables({"params": state["params"],
                              "batch_stats": state["batch_stats"]})
    with np.load(os.path.join(run, "variables.npz")) as saved:
        assert sorted(saved.files) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(saved[k], flat[k], err_msg=k)


def test_build_request_arrays_equal_jax(run_dir, tmp_path):
    from mvuld_tpu.config import load_saved_config as jload
    from mvuld_tpu.data.tokenizer import CodeTokenizer as JTok
    from mvuld_tpu.train.predict import _resolve_run_dir
    from mvuld_tpu.train.predict import build_request as jbuild
    from mvuld_tpu_torch.config import load_saved_config as pload
    from mvuld_tpu_torch.data.tokenizer import CodeTokenizer as PTok
    from mvuld_tpu_torch.train.predict import build_request as pbuild

    run = _resolve_run_dir(run_dir)
    tok_path = os.path.join(run, "tokenizer.json")
    sources = [("f1", C1), ("f2", C2), ("bad", "int x;\n"), ("f3", C3)]
    ja, jrows = jbuild(sources, jload(run), JTok.load(tok_path),
                       str(tmp_path / "j"))
    pa, prows = pbuild(sources, pload(run), PTok.load(tok_path),
                       str(tmp_path / "p"))
    assert jrows == prows
    assert ja.keys() == pa.keys()
    for k in ja:
        assert ja[k].dtype == pa[k].dtype, k
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)


def test_predict_cli_matches_jax(run_dir, tmp_path):
    from mvuld_tpu.train.predict import main as jmain
    from mvuld_tpu_torch.train.predict import main as pmain

    paths = _write_sources(tmp_path, [("f1", C1), ("f2", C2),
                                      ("bad", "int x;\n"), ("f3", C3)])
    out_path = str(tmp_path / "preds.jsonl")
    want = jmain(["--run-dir", run_dir, *paths, "--batch-size", "4",
                  "--workdir", str(tmp_path / "wj")])
    got = pmain(["--run-dir", run_dir, *paths, "--batch-size", "4",
                 "--device", "cpu", "--workdir", str(tmp_path / "wp"),
                 "--out", out_path])
    assert [r["id"] for r in got] == [r["id"] for r in want] == \
        ["f1", "f2", "bad", "f3"]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g.get("error") == w.get("error")
        if "p_vul" in w:
            assert abs(g["p_vul"] - w["p_vul"]) <= 1e-4, (g, w)
            assert g["num_nodes"] == w["num_nodes"]
    p = [r["p_vul"] for r in got if "p_vul" in r]
    assert max(p) - min(p) > 1e-3          # the functions are told apart
    lines = [json.loads(ln) for ln in open(out_path)]
    assert lines[-1]["summary"] is True and lines[-1]["device"] == "cpu"
    assert lines[-1]["functions"] == 3 and lines[-1]["errors"] == 1


def test_predict_bucket_invariance(run_dir, tmp_path):
    """P(vul) must not depend on the bucket a function rides in, nor on
    packing the per-line encoder."""
    from mvuld_tpu_torch.train.predict import main

    paths = _write_sources(tmp_path, [("g1", C1), ("g2", C2), ("g3", C3)])
    runs = [main(["--run-dir", run_dir, *paths, "--device", "cpu",
                  "--workdir", str(tmp_path / f"w{i}"), *extra])
            for i, extra in enumerate((["--batch-size", "4"],
                                       ["--batch-size", "1"],
                                       ["--batch-size", "4",
                                        "--node-capacity", "40"]))]
    base = {r["id"]: r["p_vul"] for r in runs[0]}
    for other in runs[1:]:
        p = {r["id"]: r["p_vul"] for r in other}
        assert p.keys() == base.keys()
        for k in p:
            assert abs(p[k] - base[k]) < 1e-5, (k, p[k], base[k])


def test_predict_data_pickle_reads_id_by_column(run_dir, tmp_path):
    """--data on a pickle with an ``_id`` column: the ids come through
    (itertuples() would rename the leading-underscore column)."""
    import pandas as pd

    from mvuld_tpu_torch.train.predict import main
    pkl = str(tmp_path / "corpus.pkl")
    pd.DataFrame({"_id": [101, 202, 303], "func_before": [C1, C2, C3],
                  "vul": [0, 1, 0]}).to_pickle(pkl)
    got = main(["--run-dir", run_dir, "--data", pkl, "--limit", "2",
                "--device", "cpu", "--workdir", str(tmp_path / "w")])
    assert [r["id"] for r in got] == ["101", "202"]
    assert all(0.0 <= r["p_vul"] <= 1.0 for r in got)


def test_predict_east_ckpt_matches_jax(run_dir, tmp_path, monkeypatch):
    """--east-ckpt: both CLIs with the same detector (the oracle of
    tests/test_torch_ocr.py patched into both packages'
    ``load_east_detector``) write the same ``pos_ocr`` pickles and give
    P(vul) within 1e-5."""
    from mvuld_tpu.ocr import detect as jdetect
    from mvuld_tpu.train.predict import main as jmain
    from mvuld_tpu_torch.ocr import detect as pdetect
    from mvuld_tpu_torch.train.predict import main as pmain
    from test_torch_ocr import oracle_detector, read_pickles

    paths = _write_sources(tmp_path, [("h1", C1), ("h2", C2), ("h3", C3)])
    jw, pw = tmp_path / "wj", tmp_path / "wp"
    loads = []

    def stand_in(work):
        def load(ckpt, device="cuda"):
            loads.append((ckpt, str(device)))
            return oracle_detector(work / "imgs", work / "pos"), None
        return load
    monkeypatch.setattr(jdetect, "load_east_detector", stand_in(jw))
    monkeypatch.setattr(pdetect, "load_east_detector", stand_in(pw))
    want = jmain(["--run-dir", run_dir, *paths, "--batch-size", "4",
                  "--east-ckpt", "east", "--workdir", str(jw)])
    out_path = str(tmp_path / "preds.jsonl")
    got = pmain(["--run-dir", run_dir, *paths, "--batch-size", "4",
                 "--device", "cpu", "--east-ckpt", "east", "--workdir",
                 str(pw), "--out", out_path])
    assert loads == [("east", "cuda"), ("east", "cpu")]
    ocr = read_pickles(pw / "pos_ocr")
    assert ocr == read_pickles(jw / "pos_ocr")
    assert sorted(ocr) == ["h1.pkl", "h2.pkl", "h3.pkl"]
    assert all(len(v) >= 3 for v in ocr.values())
    assert [r["id"] for r in got] == [r["id"] for r in want]
    for g, w in zip(got, want):
        assert abs(g["p_vul"] - w["p_vul"]) <= 1e-5, (g, w)
    lines = [json.loads(ln) for ln in open(out_path)]
    assert lines[-1]["positions"] == "ocr"


def test_predict_serves_a_port_training_run(tmp_path):
    from mvuld_tpu_torch.config import load_saved_config
    from mvuld_tpu_torch.core.checkpoint import restore, resume_bestf1_helper
    from mvuld_tpu_torch.data.tokenizer import CodeTokenizer
    from mvuld_tpu_torch.train.predict import (_resolve_run_dir,
                                               build_request, serve)
    from mvuld_tpu_torch.train.predict import main as predict
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model
    from mvuld_tpu_torch.train.train_e2e import main as train

    out = str(tmp_path / "run")
    train(["--synthetic", "24", "--batch-size", "8", "--output", out,
           "--device", "cpu", "--opts", *TOY_OPTS, "TRAIN.EPOCHS", "1"])
    run = _resolve_run_dir(out)
    assert not os.path.exists(os.path.join(run, "variables.npz"))
    sources = [("f1", C1), ("f2", C2), ("f3", C3)]
    paths = _write_sources(tmp_path, sources)
    got = predict(["--run-dir", out, *paths, "--device", "cpu",
                   "--batch-size", "4", "--workdir", str(tmp_path / "w")])

    cfg = load_saved_config(run)
    tok = CodeTokenizer.load(os.path.join(run, "tokenizer.json"))
    model = build_e2e_model(cfg, tok.vocab_size)[0]
    restore(resume_bestf1_helper(run), model)
    model.eval()
    import torch
    arrs, rows = build_request(sources, cfg, tok, str(tmp_path / "w2"))
    want = serve(model, arrs, 4, torch.device("cpu"))
    assert [r["id"] for r in got] == ["f1", "f2", "f3"]
    np.testing.assert_array_equal(
        [r["p_vul"] for r in got],
        [round(float(want[r["_slot"]]), 6) for r in rows])


# ------------------------------------------- serving's packed line encoder

def _toy_e2e(capacity=None):
    """A tiny fp32 ``EndToEndMVulD`` (plain layers) with seeded weights, all
    of them moved off their initial values so every tower reaches P(vul)."""
    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model

    cfg = get_config(SimpleNamespace(cfg=None, opts=TOY_OPTS,
                                     output="unused"))
    model = build_e2e_model(cfg, 50, node_capacity=capacity)[0]
    gen = torch.Generator().manual_seed(0)
    init_jax_like(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return cfg, model.eval()


def _serve_rows(cfg, counts, seed=3):
    """Featurised rows with ``counts[i]`` valid lines in row i."""
    rng = np.random.RandomState(seed)
    n = len(counts)
    M, T, Tn, S = (cfg.DATA.MAX_NODES, cfg.DATA.FUNC_TOKENS,
                   cfg.DATA.NODE_TOKENS, cfg.DATA.IMG_SIZE)
    node_mask = (np.arange(M)[None] < np.asarray(counts)[:, None]).astype(
        np.float32)
    func_ids = rng.randint(3, 50, (n, T)).astype(np.int32)
    func_ids[:, T // 2:] = 1
    node_ids = rng.randint(3, 50, (n, M, Tn)).astype(np.int32)
    node_ids[..., 6:] = 1
    node_ids[node_mask == 0] = 1
    both = node_mask[:, :, None] * node_mask[:, None, :] > 0
    adj = ((rng.rand(n, M, M) < 0.3) & both) | (np.eye(M, dtype=bool) & both)
    return {"func_ids": func_ids, "node_ids": node_ids,
            "image": rng.randn(n, S, S, 3).astype(np.float32),
            "pos": (rng.rand(n, M, 4) * node_mask[..., None]).astype(
                np.float32),
            "adj": adj.astype(np.uint8), "node_mask": node_mask}


@pytest.mark.parametrize("valid,slots,want", [
    (0, 64, 16), (1, 64, 16), (16, 64, 16), (17, 64, 32), (63, 64, 64),
    (64, 64, 64), (5, 8, 8), (0, 8, 8)])
def test_line_rows_rounds_up_to_the_granule(valid, slots, want):
    from mvuld_tpu_torch.train.predict import LINE_GRANULE, line_rows
    assert LINE_GRANULE == 16
    assert line_rows(valid, slots) == want


# counts of valid lines a row (MAX_NODES 16), served at batch 4 (64 slots)
SERVE_CASES = {
    "padded_tail": [3, 9, 0, 12, 7, 2, 5],   # 4 + 3 rows, tail 21 → 32
    "on_granule": [4, 4, 4, 4],              # 16 → 16
    "granule_plus_one": [4, 4, 4, 5],        # 17 → 32
    "no_lines": [0, 0, 0, 0],                # one granule, nothing taken
}
ENCODED = {"padded_tail": 32 + 32, "on_granule": 16, "granule_plus_one": 32,
           "no_lines": 16}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_packed_lines_equal_every_slot(case, monkeypatch):
    """``serve`` with ``node_capacity`` None encodes each chunk's valid
    lines only and gives the P(vul) of encoding every slot within 1e-5."""
    import torch

    from mvuld_tpu_torch.train import predict

    cfg, model = _toy_e2e()
    arrs = _serve_rows(cfg, SERVE_CASES[case])
    predict.reset_line_counters()
    got = predict.serve(model, arrs, 4, torch.device("cpu"))
    assert predict.line_counters()["encoded"] == ENCODED[case]
    monkeypatch.setattr(predict, "line_rows", lambda valid, slots: slots)
    want = predict.serve(model, arrs, 4, torch.device("cpu"))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_line_counters_count_a_known_request():
    """7 rows at batch 4: a chunk of 4 and a tail of 3 padded to 4 with a
    copy of its first row; a model built with a capacity keeps it."""
    import torch

    from mvuld_tpu_torch.train import predict

    counts = [3, 4, 5, 6, 7, 2, 1]
    cfg, model = _toy_e2e()
    arrs = _serve_rows(cfg, counts)
    predict.reset_line_counters()
    predict.serve(model, arrs, 4, torch.device("cpu"))
    # 18 lines → 32 rows; the tail's 10 + the copy's 7 = 17 → 32 rows
    assert predict.line_counters() == {"slots": 128, "lines": 28,
                                       "encoded": 64}
    predict.reset_line_counters()
    assert predict.line_counters() == {"slots": 0, "lines": 0, "encoded": 0}
    _, fixed = _toy_e2e(capacity=8)
    predict.serve(fixed, arrs, 4, torch.device("cpu"))
    assert predict.line_counters() == {"slots": 128, "lines": 28,
                                       "encoded": 16}


def test_forward_without_line_rows_is_unchanged():
    """Training's forward passes no ``line_rows``: a packed training batch
    (dropout, DropPath, masks drawn over the slots) gives the same logits
    to the bit whatever ``line_rows`` would say, since the model's
    ``node_capacity`` wins, and runs the same operators on the same
    shapes."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append((str(func), tuple(
                tuple(a.shape) for a in args if isinstance(a, torch.Tensor))))
            return func(*args, **(kwargs or {}))

    cfg, model = _toy_e2e(capacity=24)
    model.train()
    inp = {k: torch.as_tensor(v) for k, v in
           _serve_rows(cfg, [3, 9, 0, 12]).items()}
    out, ops = [], []
    for extra in ({}, {"line_rows": 64}, {"line_rows": 16}):
        with Ops() as rec:
            out.append(model(inp["func_ids"].long(), inp["node_ids"].long(),
                             inp["image"], inp["pos"], inp["adj"] > 0,
                             inp["node_mask"], train=True,
                             gen=torch.Generator().manual_seed(5), **extra))
        ops.append(rec.seen)
    assert model.line_batch(64) == model.line_batch(64, 16) == 24
    for o, seen in zip(out[1:], ops[1:]):
        assert torch.equal(o, out[0])
        assert seen == ops[0]
