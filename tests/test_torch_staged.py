"""The port's staged path (text → caches → fusion → pipeline) against the
JAX package, on the CPU, at narrow widths and two layers.

- ``UniXcoderClassifier`` / ``UniXcoderEmbedder``: outputs and gradients
  against JAX on converted weights (fp32, 1e-5 outputs; gradients 1e-5 +
  1e-4 of the tensor's largest value: other summation orders), with and
  without per-layer checkpointing, which changes no number — also with
  dropout on, where the recomputed layer must replay its masks.
- ``train_text.main`` on ``--synthetic 48``: the losses logged every two
  steps against JAX's ``train_text.main`` from JAX's initial variables,
  dropout the identity on both sides (the frameworks draw other masks),
  within 5e-4 (logged to 4 decimals; fp32 drift over 8 steps); the
  ``--save-embeddings`` pickles hold the same keys and, after those 8 steps
  from equal weights, values within 2e-3.
- ``build_fusion_cache`` on the same corpus with the random encoders against
  JAX's: every column equal, floats to 1e-6, with DATA.NODE_NUMERIC and
  DATA.NODE_CONTEXT honoured; a second call rebuilds nothing. Both sides
  read the same rendered PNGs and positions (rendered once by the JAX side:
  the renderer's port is held against JAX in the serving tests).
- ``train_fusion.main`` on JAX's caches: first losses of each epoch against
  JAX's from JAX's initial variables within 5e-4; TRAIN.DEVICE_DATA and
  TRAIN.DEVICE_EVAL on give exactly the losses and metrics of off.
- ``pipeline.main --synthetic`` end to end with a one-epoch SwinV2
  fine-tune: JAX's summary keys, finite metrics; ``--arch
  multi_defect_nograph`` trains that key; ``--east-ckpt`` against JAX's
  with one stand-in detector: the OCR stats, ``pos_ocr`` pickles and the
  OCR-positioned caches' positions equal.
"""

import json
import os
import pickle
import shutil
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu_torch.models.convert import (flatten_variables,
                                            jax_variables_to_torch)
from jax_reference import no_persistent_compile_cache  # noqa: F401
from test_torch_models import _random_variables, _unflatten

TEXT = ["MODEL.UNIXCODER.LAYERS", "2", "MODEL.UNIXCODER.HIDDEN", "32",
        "MODEL.UNIXCODER.HEADS", "2", "MODEL.UNIXCODER.INTERMEDIATE", "64",
        "DATA.FUNC_TOKENS", "48", "PARALLEL.DTYPE", "float32"]
GRAPH = ["DATA.MAX_NODES", "16", "DATA.NODE_TOKENS", "12",
         "MODEL.MULTI.HIDDEN", "64", "MODEL.MULTI.NUM_RS_GCN", "1",
         "MODEL.MULTI.NUM_HIDDEN_FC", "1"]
SCHED = ["TRAIN.WARMUP_EPOCHS", "1", "TRAIN.BASE_LR", "2e-3",
         "TRAIN.WARMUP_LR", "1e-4", "TRAIN.MIN_LR", "1e-4",
         "TRAIN.EARLY_STOP_PATIENCE", "20"]


SUB = os.path.join("swinv2_base_patch4_window24to28", "default")


def _cfgs(opts):
    from mvuld_tpu.config import get_config as jget
    from mvuld_tpu_torch.config import get_config as pget
    ns = SimpleNamespace(cfg=None, opts=opts, output="unused")
    return jget(ns), pget(ns)


def _losses(log_path):
    with open(log_path) as f:
        return [float(line.split(": loss ")[1].split()[0])
                for line in f if ": loss " in line]


def _no_dropout(monkeypatch):
    from mvuld_tpu_torch.models import dropout
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(dropout, "apply_keep", lambda x, mask, rate: x)


# ------------------------------------------------------------ UniXcoder

def _text_models(kind, remat):
    from mvuld_tpu.models import roberta as jr
    from mvuld_tpu.models import unixcoder as ju
    from mvuld_tpu_torch.models import roberta as pr
    from mvuld_tpu_torch.models import unixcoder as pu
    dims = dict(vocab_size=60, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=40)
    name = {"classifier": "UniXcoderClassifier",
            "embedder": "UniXcoderEmbedder"}[kind]
    jm = getattr(ju, name)(jr.RobertaConfig(**dims), remat=remat)
    pm = getattr(pu, name)(pr.RobertaConfig(**dims), remat=remat)
    return jm, pm


def _ids(seed=3, B=3, T=20):
    ids = np.random.RandomState(seed).randint(3, 60, (B, T)).astype(np.int32)
    ids[:, 14:] = 1
    ids[0, 9:] = 1
    return ids


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("kind", ["classifier", "embedder"])
def test_unixcoder_matches_jax(kind, remat):
    jm, pm = _text_models(kind, remat)
    ids = _ids()
    flat = _random_variables(jm, (jnp.asarray(ids),), {}, seed=4)
    w = np.random.RandomState(5).randn(3, 32).astype(np.float32)

    def loss_fn(params):
        first, sent = jm.apply({"params": params}, jnp.asarray(ids))
        head = first.sum() if kind == "classifier" else (first ** 2).mean()
        return head + (sent * w).sum(), (first, sent)

    (_, (jfirst, jsent)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        _unflatten(flat)["params"])
    jax_variables_to_torch(flat, pm)
    first, sent = pm(torch.as_tensor(ids))
    np.testing.assert_allclose(first.detach().numpy(), np.asarray(jfirst),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(sent.detach().numpy(), np.asarray(jsent),
                               atol=1e-5, rtol=1e-5)
    head = first.sum() if kind == "classifier" else (first ** 2).mean()
    names, params = zip(*pm.named_parameters())
    grads = torch.autograd.grad(head + (sent * torch.as_tensor(w)).sum(),
                                params)
    ref = _text_models(kind, remat)[1]
    jax_variables_to_torch({"params/" + k: np.asarray(v) for k, v in
                            flatten_variables(jgrads).items()}, ref)
    want = ref.state_dict()
    for name, g in zip(names, grads):
        err = float((g - want[name]).abs().max())
        assert err <= 1e-5 + 1e-4 * float(want[name].abs().max()), (name, err)


def test_text_remat_replays_dropout_masks():
    """Checkpointed layers under dropout: the same loss, gradients and final
    generator state as the uncheckpointed model from an equal seed."""
    from mvuld_tpu_torch.models.convert import init_jax_like
    _, base = _text_models("classifier", False)
    _, remat = _text_models("classifier", True)
    init_jax_like(base, torch.Generator().manual_seed(0))
    remat.load_state_dict(base.state_dict())
    ids = torch.as_tensor(_ids())
    out = []
    for m in (base, remat):
        gen = torch.Generator().manual_seed(1)
        logits, _ = m(ids, True, gen)
        grads = torch.autograd.grad(logits[:, 0].sum(), list(m.parameters()))
        out.append((logits.detach(), grads, gen.get_state()))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    assert torch.equal(out[0][2], out[1][2])
    eval_logits, _ = base(ids)
    assert not torch.equal(eval_logits, out[0][0])       # dropout was on


def test_e2e_text_remat_follows_the_config():
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model
    from test_torch_models import E2E_OPTS
    for opts, want in ((["TRAIN.TEXT_REMAT", "on"], True),
                       (["TRAIN.TEXT_REMAT", "off",
                         "TRAIN.USE_CHECKPOINT", "True"], False),
                       (["TRAIN.USE_CHECKPOINT", "True"], True), ([], False)):
        _, pcfg = _cfgs(E2E_OPTS + opts)
        model, _, _ = build_e2e_model(pcfg, 50)
        assert model.text_encoder.remat is want


# ------------------------------------------------------------ train_text

TEXT_CLI = TEXT + SCHED + ["TRAIN.EPOCHS", "2", "PRINT_FREQ", "2"]


def test_train_text_cli_matches_jax(tmp_path, monkeypatch):
    from mvuld_tpu.models.roberta import RobertaConfig as JCfg
    from mvuld_tpu.models.unixcoder import UniXcoderClassifier as JCls
    from mvuld_tpu.train.train_text import main as jmain
    from mvuld_tpu_torch.data.tokenizer import vocab_size_of
    from mvuld_tpu_torch.models import convert
    from mvuld_tpu_torch.train.train_text import main as pmain

    _no_dropout(monkeypatch)
    common = ["--synthetic", "48", "--batch-size", "8", "--opts", *TEXT_CLI]
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jres = jmain(["--output", jout, "--save-embeddings",
                  os.path.join(jout, "emb.pkl"), *common])
    sub = SUB
    jcfg, _ = _cfgs(TEXT_CLI)
    u = jcfg.MODEL.UNIXCODER
    vocab = vocab_size_of(os.path.join(jout, sub, "tokenizer.json"))
    init = JCls(JCfg(vocab_size=max(vocab, 16), hidden_size=u.HIDDEN,
                     num_layers=u.LAYERS, num_heads=u.HEADS,
                     intermediate_size=u.INTERMEDIATE,
                     max_position_embeddings=u.MAX_POSITIONS),
                num_classes=2).init(
        jax.random.PRNGKey(jcfg.SEED),
        jnp.zeros((2, jcfg.DATA.FUNC_TOKENS), jnp.int32))
    flat = flatten_variables(jax.device_get(init))
    monkeypatch.setattr(convert, "init_jax_like",
                        lambda model, gen: jax_variables_to_torch(flat,
                                                                  model))
    res = pmain(["--output", pout, "--device", "cpu", "--save-embeddings",
                 os.path.join(pout, "emb.pkl"), *common])
    mine = _losses(os.path.join(pout, sub, "log_rank0.txt"))
    ref = _losses(os.path.join(jout, sub, "log_rank0.txt"))
    assert len(mine) == len(ref) >= 4
    np.testing.assert_allclose(mine, ref, atol=5e-4)
    assert len(res["history"]) == len(jres["history"]) == 2
    assert res.get("test_metrics") is not None
    assert res["best_epoch"] == jres["best_epoch"]
    assert os.path.exists(os.path.join(pout, sub, "tokenizer.json"))
    assert res["roberta_config"].vocab_size == max(vocab, 16)

    with open(os.path.join(pout, "emb.pkl"), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(jout, "emb.pkl"), "rb") as f:
        want = pickle.load(f)
    assert sorted(got) == sorted(want) and len(got) == 48
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == (32,)
        np.testing.assert_allclose(got[k], np.asarray(v), atol=2e-3)

    # --test evaluates the test split only
    only = pmain(["--output", str(tmp_path / "t"), "--device", "cpu",
                  "--test", *common])
    assert set(only) == {"test_metrics"}
    assert np.isfinite(only["test_metrics"]["acc"])


def test_train_text_pipeline_parallel_raises(tmp_path):
    from mvuld_tpu_torch.train.train_text import main
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        main(["--synthetic", "24", "--batch-size", "8", "--output",
              str(tmp_path), "--device", "cpu", "--opts", *TEXT,
              "PARALLEL.PP", "2"])


def test_pretrained_encoder_loads_hf_names(tmp_path):
    """An HF state dict, bare or under ``encoder.``, loads into the
    classifier's encoder; the pooler is dropped, a missing tensor raises."""
    from mvuld_tpu_torch.train.train_text import load_pretrained_encoder
    _, src = _text_models("classifier", False)
    _, dst = _text_models("classifier", False)
    for p in src.parameters():
        torch.nn.init.normal_(p, generator=torch.Generator().manual_seed(2))
    sd = {"encoder." + k: v for k, v in src.encoder.state_dict().items()}
    sd["encoder.pooler.dense.weight"] = torch.zeros(32, 32)
    sd["classifier.weight"] = torch.zeros(2, 32)
    torch.save(sd, tmp_path / "wrapped.bin")
    load_pretrained_encoder(dst.encoder, str(tmp_path / "wrapped.bin"))
    for k, v in src.encoder.state_dict().items():
        assert torch.equal(dst.encoder.state_dict()[k], v)
    bare = {k: v for k, v in src.encoder.state_dict().items()}
    bare.pop("embeddings.LayerNorm.bias")
    torch.save(bare, tmp_path / "bare.bin")
    with pytest.raises(KeyError, match="LayerNorm.bias"):
        load_pretrained_encoder(dst.encoder, str(tmp_path / "bare.bin"))


# ------------------------------------------------------ caches and fusion

FUSION = GRAPH + ["DATA.FUNC_TOKENS", "48", "PARALLEL.DTYPE", "float32"]
FUSION_CLI = FUSION + SCHED + ["TRAIN.EPOCHS", "2", "PRINT_FREQ", "50"]


@pytest.fixture(scope="module")
def corpus():
    from mvuld_tpu.tools.dataset import prepare_corpus
    from mvuld_tpu.tools.synthetic import generate_dataset
    return prepare_corpus(generate_dataset(48, seed=42))


@pytest.fixture(scope="module")
def jax_cache(corpus, tmp_path_factory):
    """JAX's fusion caches of the corpus (random encoders, a 2048-token
    tokenizer as ``train_fusion.main`` trains it), rendered once."""
    from mvuld_tpu.data.tokenizer import CodeTokenizer
    from mvuld_tpu.train.precompute import (build_fusion_cache,
                                            make_random_encoders)
    jcfg, _ = _cfgs(FUSION)
    out = str(tmp_path_factory.mktemp("jax_cache"))
    tok = CodeTokenizer.train(corpus.func_before.tolist(), vocab_size=2048)
    text_enc, swin_enc = make_random_encoders(jcfg)
    paths = build_fusion_cache(corpus, out, jcfg, text_encoder=text_enc,
                               swin_encoder=swin_enc, tokenizer=tok)
    return out, paths


def _share_renders(src, dst):
    for sub in ("imgs", "pos"):
        shutil.copytree(os.path.join(src, sub), os.path.join(dst, sub))


def _assert_same_npz(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_fusion_cache_matches_jax(corpus, jax_cache, tmp_path):
    from mvuld_tpu_torch.data.tokenizer import CodeTokenizer
    from mvuld_tpu_torch.train.precompute import (build_fusion_cache,
                                                  make_random_encoders)
    jdir, jpaths = jax_cache
    _, pcfg = _cfgs(FUSION)
    out = str(tmp_path / "cache")
    os.makedirs(out)
    _share_renders(jdir, out)
    tok = CodeTokenizer.train(corpus.func_before.tolist(), vocab_size=2048)
    text_enc, swin_enc = make_random_encoders(pcfg)
    paths = build_fusion_cache(corpus, out, pcfg, text_encoder=text_enc,
                               swin_encoder=swin_enc, tokenizer=tok)
    assert sorted(paths) == sorted(jpaths) == ["test", "train", "val"]
    for part in paths:
        _assert_same_npz(paths[part], jpaths[part])
    z = np.load(paths["train"])
    assert z["node_emb"].any() and z["img_emb"].any() and z["token_ids"].any()
    # idempotent: a second call leaves the files as they are
    stamps = {p: os.path.getmtime(p) for p in paths.values()}
    again = build_fusion_cache(corpus, out, pcfg, text_encoder=None,
                               swin_encoder=None, tokenizer=None)
    assert again == paths
    assert stamps == {p: os.path.getmtime(p) for p in paths.values()}


def test_fusion_cache_numeric_and_deps_context_match_jax(corpus, jax_cache,
                                                         tmp_path):
    """DATA.NODE_NUMERIC widens ``pos`` and DATA.NODE_CONTEXT deps changes
    the node texts, on the rows of the val split."""
    from mvuld_tpu.data.tokenizer import CodeTokenizer as JTok
    from mvuld_tpu.train.precompute import build_fusion_cache as jbuild
    from mvuld_tpu.train.precompute import make_random_encoders as jenc
    from mvuld_tpu_torch.data.tokenizer import CodeTokenizer
    from mvuld_tpu_torch.train.precompute import (build_fusion_cache,
                                                  make_random_encoders)
    opts = FUSION + ["DATA.NODE_NUMERIC", "2", "DATA.NODE_CONTEXT", "deps"]
    jcfg, pcfg = _cfgs(opts)
    rows = corpus[corpus.label == "val"]
    texts = corpus.func_before.tolist()
    outs = []
    for build, enc, tok_cls, cfg, name in (
            (jbuild, jenc, JTok, jcfg, "jax"),
            (build_fusion_cache, make_random_encoders, CodeTokenizer, pcfg,
             "port")):
        out = str(tmp_path / name)
        os.makedirs(out)
        _share_renders(jax_cache[0], out)
        text_enc, swin_enc = enc(cfg)
        outs.append(build(rows, out, cfg, text_encoder=text_enc,
                          swin_encoder=swin_enc,
                          tokenizer=tok_cls.train(texts, vocab_size=2048)))
    _assert_same_npz(outs[1]["val"], outs[0]["val"])
    z, base = np.load(outs[1]["val"]), np.load(jax_cache[1]["val"])
    assert z["pos"].shape[-1] == 8 and base["pos"].shape[-1] == 4
    assert not np.array_equal(z["token_ids"], base["token_ids"])


def test_encode_cache_columns_over_arrays():
    """The encoder half alone, from arrays: ids and images in, columns out,
    rows scattered by (row, node), ragged last batches included."""
    from mvuld_tpu_torch.train.precompute import (empty_cache_columns,
                                                  encode_cache_columns)
    _, pcfg = _cfgs(FUSION + ["MODEL.MULTI.TEXT_DIM", "8",
                              "MODEL.MULTI.IMG_DIM", "6"])
    arrs = empty_cache_columns(5, pcfg)
    rng = np.random.RandomState(0)
    func_ids = rng.randint(3, 99, (5, 48))
    line_ids = rng.randint(3, 99, (7, 12))
    index = np.array([[0, 0], [0, 1], [1, 0], [2, 0], [2, 1], [2, 2], [4, 0]])
    images = rng.randn(5, 4, 4, 3).astype(np.float32)
    calls = []

    def text_encoder(ids):
        calls.append(len(ids))
        return np.repeat(ids[:, :1].astype(np.float32), 8, 1)

    encode_cache_columns(
        arrs, func_ids=func_ids, line_ids=line_ids, line_index=index,
        images=lambda lo, hi: images[lo:hi], text_encoder=text_encoder,
        swin_encoder=lambda x: x.reshape(len(x), -1)[:, :6], encode_batch=2)
    assert calls == [2, 2, 1, 2, 2, 2, 1]
    np.testing.assert_array_equal(arrs["text_emb"][:, 0], func_ids[:, 0])
    np.testing.assert_array_equal(arrs["token_ids"][2, 1], line_ids[4])
    np.testing.assert_array_equal(arrs["node_emb"][4, 0, 0], line_ids[6, 0])
    assert not arrs["node_emb"][3].any() and not arrs["token_ids"][1, 1].any()
    np.testing.assert_array_equal(arrs["img_emb"],
                                  images.reshape(5, -1)[:, :6])
    assert arrs["pos"].shape == (5, 16, 4) and arrs["adj"].dtype == np.uint8


def _fusion_run(main, cache_dir, out, extra=()):
    return main(["--cache-dir", cache_dir, "--batch-size", "8", "--output",
                 out, *extra, "--opts", *FUSION_CLI])


def test_train_fusion_cli_matches_jax(jax_cache, tmp_path, monkeypatch):
    from mvuld_tpu.models.fusion_zoo import build_fusion_model as jbuild
    from mvuld_tpu.train.train_fusion import main as jmain
    from mvuld_tpu_torch.models import convert
    from mvuld_tpu_torch.train.train_fusion import main as pmain

    _no_dropout(monkeypatch)
    cache_dir = jax_cache[0]
    jout = str(tmp_path / "jax")
    jres = _fusion_run(jmain, cache_dir, jout)
    jcfg, _ = _cfgs(FUSION_CLI)
    z = np.load(jax_cache[1]["train"])
    one = {k: jnp.asarray(z[k][:1]) for k in
           ("img_emb", "text_emb", "node_emb", "pos", "node_mask", "ntype")}
    init = jbuild(jcfg).init(jax.random.PRNGKey(jcfg.SEED), **one,
                             adj=jnp.asarray(z["adj"][:1] > 0), train=False)
    flat = flatten_variables(jax.device_get(init))
    monkeypatch.setattr(convert, "init_jax_like",
                        lambda model, gen: jax_variables_to_torch(flat,
                                                                  model))
    runs = {}
    for name, extra in (("host", []),
                        ("device", ["TRAIN.DEVICE_DATA", "True",
                                    "TRAIN.DEVICE_EVAL", "True"])):
        out = str(tmp_path / name)
        res = pmain(["--cache-dir", cache_dir, "--batch-size", "8",
                     "--output", out, "--device", "cpu", "--opts",
                     *FUSION_CLI, *extra])
        runs[name] = (res, _losses(os.path.join(out, SUB, "log_rank0.txt")))
    ref = _losses(os.path.join(jout, SUB, "log_rank0.txt"))
    res, mine = runs["host"]
    assert len(mine) == len(ref) == 2
    np.testing.assert_allclose(mine, ref, atol=5e-4)
    assert len(res["history"]) == len(jres["history"]) == 2
    np.testing.assert_allclose(res["history"][0]["acc"],
                               jres["history"][0]["acc"], atol=1e-6)
    assert res.get("test_metrics") is not None
    # device-resident splits: index batches gather the same rows
    dres, dlosses = runs["device"]
    assert dlosses == mine
    assert dres["history"] == res["history"]
    assert dres["test_metrics"] == res["test_metrics"]
    with open(os.path.join(str(tmp_path / "device"), SUB,
                           "log_rank0.txt")) as f:
        log = f.read()
    assert "device-resident train split" in log
    assert "device-resident val split" in log


def test_train_fusion_device_eval_needs_its_split(jax_cache, tmp_path):
    """TRAIN.DEVICE_EVAL fails fast when the split it will evaluate is
    absent; missing caches without a corpus name the files."""
    from mvuld_tpu_torch.train.train_fusion import (load_cached_datasets,
                                                    main)
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    shutil.copy(jax_cache[1]["train"], os.path.join(cache, "train.npz"))
    with pytest.raises(FileNotFoundError, match="val.npz"):
        main(["--cache-dir", cache, "--output", str(tmp_path / "o"),
              "--device", "cpu", "--opts", *FUSION_CLI])
    ds = load_cached_datasets({"train": jax_cache[1]["train"]})
    assert "ids" not in ds["train"].columns
    assert ds["train"].columns["adj"].dtype == np.uint8


def test_adjacency_bit_filter_follows_the_graph_type():
    from mvuld_tpu.tools import vocab as jv
    from mvuld_tpu_torch.train.train_fusion import edge_bits, fusion_inputs
    for gtype in jv.GRAPH_TYPE_EDGES:
        want = 0
        for t in jv.GRAPH_TYPE_EDGES[gtype]:
            want |= 1 << jv.EDGE_TYPE_MAP[t]
        assert edge_bits(gtype) == want
    adj = torch.tensor([[[0, 1], [2, 3]]], dtype=torch.uint8)
    batch = {k: None for k in ("img_emb", "text_emb", "node_emb", "pos",
                               "node_mask")}
    out = fusion_inputs(2)({**batch, "adj": adj})
    assert out["adj"].tolist() == [[[False, False], [True, True]]]
    assert out["ntype"] is None
    ntype = torch.tensor([[3, 40]], dtype=torch.int32)
    assert fusion_inputs(2)({**batch, "adj": adj, "ntype": ntype})[
        "ntype"] is ntype


def test_build_fusion_model_sizes_every_key_from_the_config():
    """Every key of the zoo from a config with DATA.NODE_NUMERIC 1: the
    bbox projections read 4 + 2 = 6 features, the node-axis BNs hold
    DATA.MAX_NODES statistics, a key's own num_hidden=0 beats the
    config's; an unknown key raises the registry's KeyError."""
    from mvuld_tpu_torch.models.fusion_zoo import (FUSION_MODELS,
                                                   GraphBranch,
                                                   MultiDefectAblation,
                                                   build_fusion_model)
    _, pcfg = _cfgs(FUSION + ["DATA.NODE_NUMERIC", "1"])
    assert isinstance(build_fusion_model(pcfg), MultiDefectAblation)
    seen = set()
    for key in FUSION_MODELS.keys():
        model = build_fusion_model(pcfg, arch=key)
        assert isinstance(model, MultiDefectAblation)
        for name, mod in model.named_modules():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("fc_bbox", "fc_bbox_pre"):
                assert mod.in_features == 6, (key, name)
                seen.add(leaf)
            if leaf in ("bn_gat", "bn_bbox"):
                assert mod.num_features == 16, (key, name)
                seen.add(leaf)
        if isinstance(getattr(model, "graph", None), GraphBranch):
            assert hasattr(model.graph, "hidden") == (
                key not in ("multi_defect_000", "multi_defect_001",
                            "multi_defect_100", "multi_defect_nogat")), key
    assert seen == {"fc_bbox", "fc_bbox_pre", "bn_gat", "bn_bbox"}
    with pytest.raises(KeyError, match="multi_defect_new_gcn"):
        build_fusion_model(pcfg, arch="multi_defect_nonesuch")


# --------------------------------------------------------------- pipeline

PIPE = TEXT + GRAPH + SCHED + [
    "DATA.IMG_SIZE", "32", "MODEL.SWINV2.EMBED_DIM", "16",
    "MODEL.SWINV2.DEPTHS", "[1,1]", "MODEL.SWINV2.NUM_HEADS", "[2,2]",
    "MODEL.SWINV2.WINDOW_SIZE", "4",
    "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", "[0,0]",
    "MODEL.DROP_PATH_RATE", "0.0", "PRINT_FREQ", "50"]
SUMMARY_KEYS = {"text_best_f1", "text_test", "fusion_best_f1", "fusion_test",
                "arch", "image_encoder", "positions", "swin_best_f1",
                "swin_test"}


def test_pipeline_synthetic_end_to_end(tmp_path):
    from mvuld_tpu_torch.core.checkpoint import load_checkpoint
    from mvuld_tpu_torch.train.pipeline import _swin_checkpoint, main
    out = str(tmp_path / "run")
    res = main(["--synthetic", "40", "--out", out, "--batch-size", "8",
                "--text-epochs", "1", "--swin-epochs", "1",
                "--fusion-epochs", "1", "--device", "cpu", "--opts", *PIPE])
    with open(os.path.join(out, "pipeline_summary.json")) as f:
        summary = json.load(f)
    assert set(summary) == SUMMARY_KEYS
    assert set(res) == SUMMARY_KEYS | {"fusion_result"}
    assert summary["arch"] == "multi_defect_new_gcn"
    assert summary["image_encoder"] == "trained"
    assert summary["positions"] == "oracle"
    for key in ("text_best_f1", "swin_best_f1", "fusion_best_f1"):
        assert np.isfinite(summary[key])
    for key in ("text_test", "swin_test", "fusion_test"):
        assert np.isfinite(summary[key]["acc"])
    z = np.load(os.path.join(out, "cache", "train.npz"))
    # text width from the trained encoder, image width from the SwinV2
    assert z["text_emb"].shape[1] == 32 and z["img_emb"].shape[1] == 32
    assert np.isfinite(z["node_emb"]).all() and z["node_emb"].any()
    assert z["img_emb"].any()
    # the fine-tune's best-F1 checkpoint is what --swin-ckpt would load
    ckpt = _swin_checkpoint(os.path.join(out, "swin"))
    assert "head.weight" in load_checkpoint(ckpt)["params"]


def test_pipeline_east_ckpt_matches_jax(tmp_path, monkeypatch):
    """--east-ckpt with one stand-in detector (the oracle of
    tests/test_torch_ocr.py) patched into both packages'
    ``load_east_detector``: JAX's summary keys, OCR stats, ``pos_ocr``
    pickles and the positions of the OCR-positioned caches."""
    from mvuld_tpu.ocr import detect as jdetect
    from mvuld_tpu.train.pipeline import main as jmain
    from mvuld_tpu_torch.ocr import detect as pdetect
    from mvuld_tpu_torch.train.pipeline import main as pmain
    from test_torch_ocr import oracle_detector, read_pickles

    jout, pout = tmp_path / "jax", tmp_path / "port"

    def stand_in(out):
        def load(ckpt, device="cuda"):
            assert ckpt == "east"
            return oracle_detector(out / "cache" / "imgs",
                                   out / "cache" / "pos"), None
        return load
    monkeypatch.setattr(jdetect, "load_east_detector", stand_in(jout))
    monkeypatch.setattr(pdetect, "load_east_detector", stand_in(pout))
    common = ["--synthetic", "24", "--batch-size", "8", "--text-epochs", "1",
              "--fusion-epochs", "1", "--east-ckpt", "east"]
    want = jmain([*common, "--out", str(jout), "--opts", *PIPE])
    got = pmain([*common, "--out", str(pout), "--device", "cpu",
                 "--opts", *PIPE])
    ocr_keys = {"ocr_node_recovery", "ocr_images", "ocr_oracle_nodes"}
    with open(os.path.join(pout, "pipeline_summary.json")) as f:
        summary = json.load(f)
    assert set(summary) == set(want) - {"fusion_result"} == \
        SUMMARY_KEYS | ocr_keys
    assert summary["positions"] == want["positions"] == "ocr"
    for k in ocr_keys:
        assert got[k] == want[k], k
    assert got["ocr_images"] >= 20 and got["ocr_node_recovery"] > 0.9
    pos = read_pickles(pout / "cache" / "pos_ocr")
    assert pos == read_pickles(jout / "cache" / "pos_ocr")
    assert len(pos) == got["ocr_images"]
    for part in ("train", "val", "test"):
        a = np.load(os.path.join(pout, "cache_ocr", f"{part}.npz"))
        b = np.load(os.path.join(jout, "cache_ocr", f"{part}.npz"))
        np.testing.assert_array_equal(a["pos"], b["pos"])
        np.testing.assert_array_equal(a["adj"], b["adj"])
    assert np.isfinite(summary["fusion_best_f1"])


def test_pipeline_arch_runs_the_key(tmp_path):
    """``pipeline --arch multi_defect_nograph``: JAX's summary keys, the
    key in the summary, and the fusion stage trained that key."""
    from mvuld_tpu_torch.train.pipeline import main
    out = str(tmp_path / "run")
    res = main(["--synthetic", "24", "--out", out, "--batch-size", "8",
                "--text-epochs", "1", "--fusion-epochs", "1",
                "--arch", "multi_defect_nograph", "--device", "cpu",
                "--opts", *PIPE])
    with open(os.path.join(out, "pipeline_summary.json")) as f:
        summary = json.load(f)
    assert set(summary) == SUMMARY_KEYS
    assert summary["arch"] == res["arch"] == "multi_defect_nograph"
    assert summary["positions"] == "oracle"
    assert np.isfinite(summary["fusion_best_f1"])
    import glob
    logs = glob.glob(os.path.join(out, "fusion", "**", "log_rank0.txt"),
                     recursive=True)
    assert logs and "fusion arch: multi_defect_nograph" in open(logs[0]).read()
