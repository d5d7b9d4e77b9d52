"""The port's baseline trainers and patch evaluation against the JAX
package's, on the CPU, at small size.

- ``build_graph_features`` / ``build_ivdetect_features`` exactly, from a
  DataFrame and from ``CodeRows`` (no pandas).
- ``_bce_train`` for 2 epochs from JAX's initial variables: the trained
  parameters and the val/test metrics (1e-4).
- ``train_ivdetect`` and ``train_reveal`` for 2 epochs from JAX's initial
  variables against the JAX CLI's own loops (its ``main`` on the same
  small splits and widths): the trained parameters, each epoch's logged
  mean loss and the val/test metrics (1e-4); for ReVeal also the SMOTE'd
  training set and the (anchor, positive, negative) indices of every
  step, with the learner's dropout at 0 on both sides (the two packages
  draw dropout from different generators).
- ReVeal's metric step: the anchor, positive and negative passes drop the
  same units (flax applies the learner three times under one key).
- A JAX-written ``baseline_ckpt.pkl`` (each model, CLI widths) served by
  the port's ``eval_patches``: JAX's probabilities (1e-4),
  representations and ``patch_eval.json``.
- ``train_baseline.main`` for the three ``--model``s with ``--device
  cpu``: the JAX payload keys and parameter tree; the JAX package's
  ``eval_patches`` serves what the port wrote.
- ``eval_patches --model text`` over a port ``train_text`` run.
- ``--device cuda`` without a card raises in each CLI.
"""

import json
import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu.models import baselines as jb
from mvuld_tpu.train import train_baseline as jtb
from mvuld_tpu_torch.models import baselines as pb
from mvuld_tpu_torch.models.convert import (baseline_params_tree,
                                            flatten_variables,
                                            jax_variables_to_torch,
                                            torch_to_jax_names)
from mvuld_tpu_torch.train import train_baseline as ptb
from jax_reference import (no_persistent_compile_cache,  # noqa: F401
                           one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TOL = dict(atol=1e-4, rtol=1e-4)
EMB, NODES = 8, 16


class _Log:
    def info(self, msg):
        pass


def _corpus(n=30, seed=42):
    from mvuld_tpu_torch.tools.dataset import prepare_corpus
    from mvuld_tpu_torch.tools.synthetic import generate_dataset
    return prepare_corpus(generate_dataset(n, seed=seed))


def _table(df, seed=0):
    from mvuld_tpu_torch.tools.embeddings import EmbeddingTable, build_vocab
    vocab = build_vocab(df.func_before.tolist())
    vec = np.random.RandomState(seed).randn(len(vocab), EMB)
    return EmbeddingTable(vocab, vec.astype(np.float32))


def _assert_same_splits(got, want):
    assert sorted(got) == sorted(want)
    for part in want:
        assert sorted(got[part]) == sorted(want[part])
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)
            assert got[part][k].dtype == v.dtype, k


@pytest.mark.parametrize("fn", ["build_graph_features",
                                "build_ivdetect_features"])
def test_feature_functions_are_exact(fn):
    df = _corpus()
    emb = _table(df)
    want = getattr(jtb, fn)(df, emb, NODES)
    _assert_same_splits(getattr(ptb, fn)(df, emb, NODES), want)
    rows = ptb.CodeRows(df.func_before.tolist(), df.vul.tolist(),
                        df.label.tolist())
    _assert_same_splits(getattr(ptb, fn)(rows, emb, NODES), want)


def _labels(part, n, skew):
    """Alternating labels; with ``skew`` a train split of one positive in
    three (so that SMOTE has a minority to fill)."""
    every = 3 if skew and part == "train" else 2
    return (np.arange(n) % every == 0).astype(np.int32)


def _graph_data(seed=1, F=6, N=8, skew=False):
    rng = np.random.RandomState(seed)
    data = {}
    for part, n in (("train", 14), ("val", 8), ("test", 4)):
        mask = (np.arange(N)[None] < rng.randint(3, N + 1, (n, 1))
                ).astype(np.float32)
        adj = (rng.rand(n, 6, N, N) < 0.3).astype(np.float32)
        adj *= mask[:, None, :, None] * mask[:, None, None, :]
        data[part] = {"feats": (rng.randn(n, N, F) * mask[..., None]
                                ).astype(np.float32),
                      "adj_etype": adj, "node_mask": mask,
                      "label": _labels(part, n, skew)}
    return data


def _ivdetect_data(seed=2, D=4, N=6, L=3):
    """Splits as ``build_ivdetect_features`` lays them out: four token
    channels [n, N, L, D] with prefix masks (length 0 on padding nodes),
    AST and full adjacency, node masks."""
    rng = np.random.RandomState(seed)
    data = {}
    for part, n in (("train", 10), ("val", 8), ("test", 4)):
        mask = (np.arange(N)[None] < rng.randint(2, N + 1, (n, 1))
                ).astype(np.float32)
        split = {"node_mask": mask, "label": _labels(part, n, False)}
        for k in ("subseq", "nametype", "data", "control"):
            lens = rng.randint(1, L + 1, (n, N)) * mask
            m = (np.arange(L) < lens[..., None]).astype(np.float32)
            split[f"m_{k}"] = m
            split[f"f_{k}"] = (rng.randn(n, N, L, D) * m[..., None]
                               ).astype(np.float32)
        for k, p in (("ast", 0.3), ("adj", 0.5)):
            a = (rng.rand(n, N, N) < p).astype(np.float32)
            split[k] = a * mask[:, :, None] * mask[:, None, :]
        data[part] = split
    return data


def _assert_same_tree(got, want):
    got, want = (flatten_variables({"params": t}) for t in (got, want))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)


def _assert_moved(params, init):
    """Training moved some leaf of ``params`` far beyond the tolerance."""
    moved = flatten_variables({"params": params})
    start = flatten_variables(init)
    assert max(float(np.abs(moved[k] - start[k]).max()) for k in moved) > 1e-3


def _assert_same_results(got, want):
    assert sorted(got) == sorted(want) == ["test", "val"]
    for part, m in want.items():
        assert sorted(got[part]) == sorted(m)
        for k, v in m.items():
            np.testing.assert_allclose(got[part][k], v, err_msg=k, **TOL)


def _run_jax_main(name, data, tmp_path, monkeypatch, models):
    """The JAX CLI's ``main --model name`` on ``data`` (its feature builder
    and embedding trainer stubbed out, its models built by ``models``):
    its results, its checkpoint, its logged losses and the initial
    parameters of each model it trained, in order (as its optimizers
    were given them)."""
    import optax

    from mvuld_tpu.tools import embeddings as je

    table = je.EmbeddingTable({"<unk>": 0}, np.zeros((1, 4), np.float32))
    for fn in ("train_glove", "train_sgns"):
        monkeypatch.setattr(je, fn, lambda *a, **kw: table)
    for fn in ("build_graph_features", "build_ivdetect_features"):
        monkeypatch.setattr(jtb, fn, lambda *a, **kw: data)
    for cls, make in models.items():
        monkeypatch.setattr(jb, cls, make)
    inits, adam = [], optax.adam

    def recording_adam(lr):
        tx = adam(lr)

        def init(params):
            inits.append({"params": jax.device_get(params)})
            return tx.init(params)
        return optax.GradientTransformation(init, tx.update)

    monkeypatch.setattr(optax, "adam", recording_adam)
    out = str(tmp_path / "jax")
    res = jtb.main(["--model", name, "--synthetic", "8", "--epochs", "2",
                    "--batch-size", "4", "--seed", "3", "--out-dir", out])
    return (res["results"], jtb.load_baseline_ckpt(out), _logged_losses(out),
            inits)


def _logged_losses(out_dir):
    """The epochs' mean losses that the JAX CLI logged (4 decimals): the
    phase-1 / IVDetect loop's under "", the metric learner's under
    "[metric]"."""
    import re
    losses = {"": [], "[metric]": []}
    with open(os.path.join(out_dir, "log_rank0.txt")) as f:
        for tag, x in re.findall(r"INFO (\[metric\] )?epoch \d+: loss (\S+)",
                                 f.read()):
            losses[tag.strip()].append(float(x))
    return losses


def _assert_same_losses(got, logged):
    """Each epoch's mean loss as JAX logged it: within TOL of the value
    rounded to 4 decimals, so within 5e-5 more of the logged one."""
    assert len(got) == len(logged) == 2
    for g, j in zip(got, logged):
        assert g == pytest.approx(j, abs=TOL["atol"] + 5e-5)


def test_bce_train_matches_jax():
    data = _graph_data()
    kw = dict(epochs=2, lr=1e-3, seed=3, batch_size=4, logger=_Log())
    jm = jb.DevignModel(input_dim=6, output_dim=10, num_steps=2)
    j_params, j_results = jtb._bce_train(jm, data, **kw)
    # JAX's initial variables, as _bce_train draws them
    tr = data["train"]
    init = jm.init(jax.random.PRNGKey(3), *(jnp.asarray(tr[k][:2]) for k in
                                            ("feats", "adj_etype",
                                             "node_mask")))
    pm = pb.DevignModel(input_dim=6, output_dim=10, num_steps=2)
    jax_variables_to_torch(flatten_variables(jax.device_get(init)), pm)
    pm, p_results = ptb._bce_train(pm, data, **kw)
    assert len(pm.losses) == 2 and np.isfinite(pm.losses).all()
    _assert_same_tree(baseline_params_tree(pm), jax.device_get(j_params))
    _assert_same_results(p_results, j_results)


def test_train_ivdetect_matches_jax(tmp_path, monkeypatch,
                                    no_persistent_compile_cache):
    """The JAX CLI's IVDetect loop (softmax CE, dropout never on, eval
    through the softmax) against ``train_ivdetect`` from the same initial
    variables (those the CLI drew)."""
    data = _ivdetect_data()
    make = jb.IVDetect
    j_results, ck, j_losses, (init,) = _run_jax_main(
        "ivdetect", data, tmp_path, monkeypatch,
        {"IVDetect": lambda hidden, feat_dim: make(hidden=8, feat_dim=4)})
    pm = pb.IVDetect(hidden=8, feat_dim=4)
    jax_variables_to_torch(flatten_variables(init), pm)
    pm, p_results = ptb.train_ivdetect(pm, data, epochs=2, lr=1e-3, seed=3,
                                       batch_size=4, logger=_Log())
    _assert_same_losses(pm.losses, j_losses[""])
    _assert_moved(ck["params"], init)
    _assert_same_tree(baseline_params_tree(pm), ck["params"])
    _assert_same_results(p_results, j_results)


def test_train_reveal_matches_jax(tmp_path, monkeypatch,
                                  no_persistent_compile_cache):
    """The JAX CLI's ReVeal (phase 1, representations, SMOTE, the metric
    learner) against ``train_reveal`` from the same initial variables
    (those the CLI drew), the learner's dropout at 0: the SMOTE'd set, every step's triplet indices
    (JAX's draws, :403-412, replayed from the set JAX's SMOTE was given),
    both trained trees and the metrics."""
    data = _graph_data(skew=True)
    ggnn, learner, smote = jb.GGNNSum, jb.MetricLearningModel, jb.smote
    j_smote, p_smote = [], []

    def spy(calls, fn):
        def kept(features, labels, rng):
            calls.append(((features, labels), fn(features, labels, rng)))
            return calls[-1][1]
        return kept

    j_results, ck, j_losses, (g_init, ml_init) = _run_jax_main(
        "reveal", data, tmp_path, monkeypatch,
        {"GGNNSum": lambda **kw: ggnn(output_dim=10, num_steps=2),
         "MetricLearningModel": lambda **kw: learner(hidden_dim=8,
                                                     dropout_p=0.0),
         "smote": spy(j_smote, smote)})
    tr = data["train"]
    pg, pml = pb.GGNNSum(10, 2), pb.MetricLearningModel(10, 8, dropout_p=0.0)
    jax_variables_to_torch(flatten_variables(g_init), pg)
    jax_variables_to_torch(flatten_variables(ml_init), pml)
    steps = []
    step = ptb.metric_step

    def kept_step(ml, dx, dy, ia, ip, inn, keep):
        steps.append([i.tolist() for i in (ia, ip, inn)])
        return step(ml, dx, dy, ia, ip, inn, keep)

    monkeypatch.setattr(pb, "smote", spy(p_smote, pb.smote))
    monkeypatch.setattr(ptb, "metric_step", kept_step)
    p_results = ptb.train_reveal(pg, pml, data, epochs=2, lr=1e-3, seed=3,
                                 batch_size=4, logger=_Log())
    assert len(j_smote) == len(p_smote) == 1
    (j_in, (jx, jy)), (_, (px, py)) = j_smote[0], p_smote[0]
    assert len(jy) > len(tr["label"])                 # SMOTE added rows
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_allclose(px, jx, **TOL)
    rng = np.random.RandomState(3)
    x, y = smote(*j_in, rng)
    pos, neg = np.where(y == 1)[0], np.where(y == 0)[0]
    want = []
    for _ in range(2):
        order = rng.permutation(len(y))
        for b in range(len(y) // 4):
            idx = order[b * 4:(b + 1) * 4]
            xp = [rng.choice(pos if t else neg) for t in y[idx]]
            xn = [rng.choice(neg if t else pos) for t in y[idx]]
            want.append([idx.tolist(), [int(i) for i in xp],
                         [int(i) for i in xn]])
    assert steps == want
    _assert_same_losses(pg.losses, j_losses[""])
    _assert_same_losses(pml.losses, j_losses["[metric]"])
    _assert_moved(ck["params"], g_init)
    _assert_moved(ck["ml_params"], ml_init)
    _assert_same_tree(baseline_params_tree(pg), ck["params"])
    _assert_same_tree(baseline_params_tree(pml), ck["ml_params"])
    _assert_same_results(p_results, j_results)


def test_reveal_passes_share_their_dropout_masks(monkeypatch):
    """One step's three passes of the learner get the same keep-masks,
    which do drop units; a re-run from the same generator repeats them."""
    ml = pb.MetricLearningModel(12, hidden_dim=16)
    dx = torch.randn(10, 12)
    dy = torch.arange(10) % 2
    seen = []
    forward = pb.MetricLearningModel.forward

    def spy(self, x, keep=None):
        seen.append(keep)
        return forward(self, x, keep)

    monkeypatch.setattr(pb.MetricLearningModel, "forward", spy)
    gen = torch.Generator().manual_seed(5)
    ia, ip, inn = torch.arange(4), torch.arange(4, 8), torch.arange(6, 10)
    keep = ml.keep_masks(4, gen, "cpu")
    loss = ptb.metric_step(ml, dx, dy, ia, ip, inn, keep)
    assert torch.isfinite(loss)
    assert len(seen) == 3 and all(k is keep for k in seen)
    assert [m.shape for m in keep] == [(4, 16), (4, 8), (4, 16)]
    assert not all(bool(m.all()) for m in keep)
    # the same inputs through the three passes give the same features
    out = [forward(ml, dx[ia], keep)[1] for _ in range(3)]
    assert all(torch.equal(out[0], o) for o in out[1:])
    again = ml.keep_masks(4, torch.Generator().manual_seed(5), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, keep))


def _jax_model(name):
    """The JAX package's model for a checkpoint at the CLI widths."""
    input_dim = EMB + 32
    if name == "ivdetect":
        return jb.IVDetect(hidden=48, feat_dim=EMB)
    if name == "devign":
        return jb.DevignModel(input_dim=input_dim,
                              output_dim=max(input_dim, 128))
    return jb.GGNNSum(output_dim=max(input_dim, 128), num_steps=8)


def _jax_inputs(name):
    if name == "ivdetect":
        f, m = np.zeros((2, NODES, 12, EMB)), np.ones((2, NODES, 12))
        a = np.zeros((2, NODES, NODES))
        return [f, m] * 4 + [a, a, np.ones((2, NODES))]
    return [np.zeros((2, NODES, EMB + 32)), np.zeros((2, 6, NODES, NODES)),
            np.ones((2, NODES))]


def _jax_ckpt(out_dir, name, df):
    """A checkpoint as JAX's train_baseline writes it: its save function,
    variables of the CLI widths from JAX's initialisers."""
    emb = _table(df)
    init = jax.jit(_jax_model(name).init)(jax.random.PRNGKey(11), *(
        jnp.asarray(a, jnp.float32) for a in _jax_inputs(name)))
    payload = {"model": name, "params": init["params"],
               "emb_vocab": emb.vocab, "emb_vectors": emb.vectors,
               "max_nodes": NODES, "emb_dim": EMB}
    if name == "reveal":
        payload["ml_params"] = jb.MetricLearningModel(hidden_dim=128).init(
            jax.random.PRNGKey(12), jnp.zeros((2, 128)))["params"]
    if name == "ivdetect":
        payload["hidden"] = 48
    jtb.save_baseline_ckpt(out_dir, payload)


def _capturing(module, monkeypatch):
    """Wrap ``module.make_baseline_fns`` so that each run's
    (probabilities, representations) are kept."""
    runs = []
    make = module.make_baseline_fns

    def wrapped(*a, **kw):
        run, rep = make(*a, **kw)

        def kept(codes, want_repr=False):
            runs.append(run(codes, want_repr))
            return runs[-1]
        return kept, rep

    monkeypatch.setattr(module, "make_baseline_fns", wrapped)
    return runs


@pytest.mark.parametrize("name", ["devign", "reveal", "ivdetect"])
def test_jax_checkpoint_served_by_the_port(name, tmp_path, monkeypatch):
    """``eval_patches`` over a JAX-written checkpoint: JAX's
    probabilities and representations of the vulnerable and the patched
    twins, and its ``patch_eval.json``."""
    from mvuld_tpu.tools import eval_patches as jep
    from mvuld_tpu_torch.tools import eval_patches as pep

    ck = str(tmp_path / "ckpt")
    _jax_ckpt(ck, name, _corpus())
    j_runs, p_runs = _capturing(jep, monkeypatch), _capturing(pep,
                                                              monkeypatch)
    # 4 twins at batch 4: one batch shape for JAX to compile
    argv = ["--model", name, "--ckpt", ck, "--synthetic", "4",
            "--batch-size", "4"]
    want = jep.main(argv + ["--out", str(tmp_path / "jax"), "--no-tsne"])
    got = pep.main(argv + ["--out", str(tmp_path / "port"), "--no-tsne",
                           "--device", "cpu"])
    assert len(p_runs) == len(j_runs) == 2          # vulnerable, patched
    for (pp, pr), (jp, jr) in zip(p_runs, j_runs):
        assert pp.dtype == np.float64 and len(pp) == len(jp) == 4
        np.testing.assert_allclose(pp, jp, **TOL)
        assert (pr is None) == (jr is None) == (name != "reveal")
        if jr is not None:
            np.testing.assert_allclose(pr, jr, **TOL)
    with open(tmp_path / "port" / "patch_eval.json") as f:
        written = json.load(f)
    with open(tmp_path / "jax" / "patch_eval.json") as f:
        assert set(written) == set(json.load(f))
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, abs=1e-4), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("name", ["devign", "reveal", "ivdetect"])
def test_main_writes_the_jax_checkpoint(name, tmp_path):
    out = str(tmp_path / name)
    res = ptb.main(["--model", name, "--synthetic", "30", "--epochs", "1",
                    "--batch-size", "8", "--max-nodes", str(NODES),
                    "--emb-dim", str(EMB), "--out-dir", out,
                    "--device", "cpu"])
    assert sorted(res["results"]) == ["test", "val"]
    assert all(np.isfinite(v) for m in res["results"].values()
               for v in m.values() if isinstance(v, float))
    ck = ptb.load_baseline_ckpt(out)
    keys = {"model", "params", "emb_vocab", "emb_vectors", "max_nodes",
            "emb_dim"}
    keys |= {"ml_params"} if name == "reveal" else set()
    keys |= {"hidden"} if name == "ivdetect" else set()
    assert set(ck) == keys and ck["model"] == name
    inputs = [jnp.asarray(a, jnp.float32) for a in _jax_inputs(name)]
    shapes = jax.eval_shape(lambda: _jax_model(name).init(
        jax.random.PRNGKey(0), *inputs))
    want = {k: tuple(v.shape) for k, v in flatten_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape),
                               shapes)).items()}
    got = {k: v.shape for k, v in flatten_variables(
        {"params": ck["params"]}).items()}
    assert got == want
    if name == "reveal":
        assert ck["ml_params"]["layer1"]["kernel"].shape == (128, 128)
    # the JAX package serves what the port wrote
    from mvuld_tpu.tools.eval_patches import make_baseline_fns as jfns
    from mvuld_tpu_torch.tools.eval_patches import make_baseline_fns as pfns
    from mvuld_tpu_torch.tools.patch_eval import make_patch_pairs
    codes = sum(make_patch_pairs(3, seed=2), [])
    np.testing.assert_allclose(pfns(out, 8, "cpu")[0](codes)[0],
                               jfns(out, 8)[0](codes)[0], **TOL)


def test_eval_patches_serves_a_train_text_run(tmp_path):
    from mvuld_tpu_torch.data.tokenizer import CodeTokenizer
    from mvuld_tpu_torch.tools.eval_patches import main, make_text_fns
    from mvuld_tpu_torch.tools.patch_eval import make_patch_pairs
    from mvuld_tpu_torch.train.train_text import main as train_text

    opts = ["MODEL.UNIXCODER.LAYERS", "1", "MODEL.UNIXCODER.HIDDEN", "32",
            "MODEL.UNIXCODER.HEADS", "2", "MODEL.UNIXCODER.INTERMEDIATE",
            "64", "DATA.FUNC_TOKENS", "48", "PARALLEL.DTYPE", "float32",
            "TRAIN.EPOCHS", "1"]
    res = train_text(["--synthetic", "24", "--batch-size", "8", "--output",
                      str(tmp_path / "text"), "--device", "cpu",
                      "--opts", *opts])
    run_dir = str(tmp_path / "text")
    vul, fix = make_patch_pairs(4, seed=1)
    run, _ = make_text_fns(run_dir, 4, "cpu")
    probs, reprs = run(vul + fix, want_repr=True)
    model = res["model"].eval()
    tok = CodeTokenizer.load(_tokenizer_path(run_dir))
    ids = torch.as_tensor(tok.tokenize(vul + fix, max_length=48))
    with torch.no_grad():
        logits, sent = model(ids)
    np.testing.assert_allclose(probs, torch.softmax(logits, -1)[:, 1],
                               **TOL)
    np.testing.assert_allclose(reprs, sent, **TOL)
    report = main(["--model", "text", "--ckpt", run_dir, "--synthetic", "4",
                   "--no-tsne", "--out", str(tmp_path / "pe"),
                   "--device", "cpu"])
    assert report["n_pairs"] == 4 and report["model"] == "text"
    assert os.path.exists(tmp_path / "pe" / "patch_eval.json")


def _tokenizer_path(run_dir):
    for root, _dirs, files in os.walk(run_dir):
        if "tokenizer.json" in files:
            return os.path.join(root, "tokenizer.json")
    raise FileNotFoundError(run_dir)


def test_clis_default_to_cuda_and_raise_without_a_card(monkeypatch,
                                                        tmp_path):
    from mvuld_tpu_torch.tools import eval_patches, process_dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: ptb.main(["--model", "devign", "--synthetic", "8",
                               "--out-dir", str(tmp_path / "a")]),
             lambda: eval_patches.main(["--model", "devign", "--ckpt",
                                        str(tmp_path), "--out",
                                        str(tmp_path / "b")]),
             lambda: process_dataset.main(["--synthetic", "8", "--output",
                                           str(tmp_path / "c" / "c.pkl")])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_torch_to_jax_names_of_the_cli_models():
    """Every port parameter of the CLI-width models has its JAX path."""
    for name in ("devign", "reveal", "ivdetect"):
        inputs = [jnp.asarray(a, jnp.float32) for a in _jax_inputs(name)]
        shapes = jax.eval_shape(lambda: _jax_model(name).init(
            jax.random.PRNGKey(0), *inputs))
        want = set(flatten_variables(jax.tree_util.tree_map(
            lambda s: np.zeros(()), shapes)))
        pm = {"ivdetect": lambda: pb.IVDetect(48, EMB),
              "devign": lambda: pb.DevignModel(EMB + 32, 128),
              "reveal": lambda: pb.GGNNSum(128, 8)}[name]()
        assert set(torch_to_jax_names(pm).values()) == want
