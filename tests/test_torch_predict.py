"""The port's serving CLI against the JAX one, on the CPU.

A fake finished JAX run dir (saved config + tokenizer + best-F1 orbax
checkpoint of a tiny model, as tests/test_predict.py builds it) also gets
``variables.npz``: the same variables flattened with '/' keys, which is
what the port reads. Both CLIs run on the same .c sources at fp32 with the
plain layers (the JAX CLI's CPU path; the port's ``--device cpu``).

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


def test_east_ckpt_not_ported_yet(run_dir, tmp_path):
    from mvuld_tpu_torch.train.predict import main
    paths = _write_sources(tmp_path, [("h1", C1)])
    with pytest.raises(NotImplementedError, match="EAST"):
        main(["--run-dir", run_dir, *paths, "--device", "cpu",
              "--east-ckpt", "ckpt", "--workdir", str(tmp_path / "w")])


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
