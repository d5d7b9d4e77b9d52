"""The port's parallel layer against the JAX package's on the CPU.

Counterparts of ``test_parallel.py`` (the mesh, a data-parallel step that
learns), ``test_zip_dist.py::test_distributed_helpers_single_host``,
``test_sp_attention.py``, ``test_pipeline_parallel.py``,
``test_round2_fixes.py::test_tensor_parallel_sharding_matches_replicated``,
``test_moe_sharding.py`` and ``test_train_text_pp.py``, plus data
parallelism with BatchNorm held against one rank.

The JAX side runs on the 8-device CPU mesh that ``tests/conftest.py`` sets
up (Pallas in interpret mode); the port's multi-rank checks run in two
spawned gloo worlds, four ranks and two, each holding several checks
(``tests/torch_parallel_workers.py``), on free localhost ports with a
timeout on the group and the join. The pipeline runs in this process, as
its design is one process over a list of devices.

Tolerances (fp32 everywhere): a gathered or summed result differs from the
one-rank result in the last bits (summation order), so no check of a
reduced quantity asserts bit equality. Sequence-parallel attention against
JAX's sharded Pallas kernel: the JAX test's own bounds (out 1e-5, grads
rtol 1e-4 / atol 1e-5); the sharded model against JAX's XLA path 2e-4 (the
kernel's fixed softmax shift against the exact one, as in JAX's test).
Data and tensor parallelism against one rank: loss 1e-6, gradients 1e-5
relative to each tensor's largest entry (floor 1e-3; the synced BatchNorm
sums its statistics in another order), BatchNorm statistics 1e-5,
parameters after one AdamW step 1e-5 where the gradient entry exceeds
1e-3 of its tensor's largest (2·lr elsewhere: AdamW's first update
lr·g/(|g| + eps) turns a last-bit difference of a near-zero g into a
whole update). MoE against JAX's global forward 1e-5.
Pipeline against the sequential encoder 1e-5 (forward), 2e-5 / rtol 2e-4
(gradients, JAX's bounds).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from jax_reference import no_persistent_compile_cache  # noqa: F401
from mvuld_tpu_torch.models.convert import jax_variables_to_torch
from mvuld_tpu_torch.parallel.distributed import run_local_world
from test_torch_models import _graph_inputs, _random_variables

WORLD_TIMEOUT = 240


def _flatten(tree, prefix=""):
    from mvuld_tpu_torch.models.convert import flatten_variables
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_variables(jax.device_get(tree),
                                          prefix).items()}


def _tree(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *path, last = k.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[last] = jnp.asarray(v)
    return out


# ------------------------------------------------------------ JAX sides

def _sp_inputs(seed=0, B=8, nWh=2, nWw=2, ws=4, H=2, hd=8):
    rng = np.random.RandomState(seed)
    N, C = ws * ws, H * hd
    Bn = B * nWh * nWw
    return (rng.randn(Bn, N, 3 * C).astype(np.float32),
            rng.randn(H, N, N).astype(np.float32),
            (rng.rand(H) + 0.5).astype(np.float32))


def _jax_sp(shift):
    """JAX's sharded attention over mesh (2, 4), axis mp: out, loss and
    the gradients of Σ out·cos(out)."""
    from mvuld_tpu.ops.window_attention import window_attention_flat_sharded
    from mvuld_tpu.parallel.mesh import make_mesh
    qkv, bias, scale = _sp_inputs()
    mesh = make_mesh(dp=2, mp=4)

    def loss(q, b, s):
        out = window_attention_flat_sharded(q, b, s, shift=shift, nWh=2,
                                            nWw=2, mesh=mesh, axis="mp",
                                            interpret=True)
        return jnp.sum(out * jnp.cos(out)), out

    with mesh:
        (l, o), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(scale))
    return np.asarray(o), float(l), [np.asarray(t) for t in g]


SP_SWIN = dict(img_size=16, patch_size=4, embed_dim=16, depths=(2,),
               num_heads=(2,), window_size=2, pretrained_window_sizes=(0,),
               drop_path_rate=0.0)
TP_SWIN = dict(img_size=16, patch_size=4, embed_dim=16, depths=(1, 1),
               num_heads=(2, 2), window_size=4,
               pretrained_window_sizes=(0, 0), drop_path_rate=0.0)


def _jax_swin(cfg_kw, x, seed):
    """Seeded variables of the JAX SwinV2 and its XLA-path logits."""
    from mvuld_tpu.models.swin_v2 import SwinTransformerV2, SwinV2Config
    model = SwinTransformerV2(SwinV2Config(**cfg_kw))
    flat = _random_variables(model, (jnp.asarray(x),), {}, seed)
    logits = np.asarray(jax.jit(lambda v, a: model.apply(v, a))(
        _tree(flat), jnp.asarray(x)))
    return model, flat, logits


def _jax_moe(top_k, cf, x, seed):
    from mvuld_tpu.models.moe import MoEFFN
    m = MoEFFN(hidden=32, out=16, num_experts=4, top_k=top_k,
               capacity_factor=cf)
    flat = _random_variables(m, (jnp.asarray(x),), {}, seed)
    y, aux = m.apply(_tree(flat), jnp.asarray(x))
    kw = dict(dim=16, hidden=32, out=16, num_experts=4, top_k=top_k,
              capacity_factor=cf)
    params = {k.split("/")[-1]: v for k, v in flat.items()}
    return kw, params, np.asarray(y), float(aux)


MOE_CASES = [(1, 2.0), (1, 0.5), (2, 1.25)]   # top-k, capacity factor


def _moe_inputs():
    return np.random.RandomState(0).randn(8, 6, 16).astype(np.float32)


# ------------------------------------------------------------ world 4

@pytest.fixture(scope="module")
def world4():
    """JAX references, then one spawned world of four ranks running every
    four-rank check (``workers.world4``)."""
    sp_refs = {shift: _sp_inputs() for shift in (0, 2)}
    jax_sp = {shift: _jax_sp(shift) for shift in (0, 2)}

    x = np.random.RandomState(0).randn(8, 16, 16, 3).astype(np.float32)
    _, sp_flat, sp_logits = _jax_swin(SP_SWIN, x, seed=1)

    moe_x = _moe_inputs()
    moe = [_jax_moe(k, cf, moe_x, seed=2 + i)
           for i, (k, cf) in enumerate(MOE_CASES)]

    tx = np.random.RandomState(4).randn(8, 16, 16, 3).astype(np.float32)
    ty = np.random.RandomState(5).randint(0, 2, 8).astype(np.int32)
    tp_model, tp_flat, tp_logits = _jax_swin(TP_SWIN, tx, seed=6)
    from mvuld_tpu.core.train_state import cross_entropy
    jax_loss = float(cross_entropy(jnp.asarray(tp_logits), jnp.asarray(ty),
                                   0.1))

    res = run_local_world(
        workers.world4, 4, sp_refs, (SP_SWIN, sp_flat, x),
        [(kw, p, moe_x, False) for kw, p, _, _ in moe],
        (TP_SWIN, tp_flat, tx, ty), timeout=WORLD_TIMEOUT)
    return dict(res=res, jax_sp=jax_sp, sp_logits=sp_logits, moe=moe,
                tp_jax_loss=jax_loss)


def test_mesh_4_ranks(world4):
    for rank, r in enumerate(world4["res"]):
        shapes = r["mesh"]
        assert shapes[0] == (4, 1) and shapes[1] == (2, 2)
        assert shapes[2:] == (rank // 2, rank % 2, 2, 2)
        assert "needs 16 devices, have 4" in r["mesh_8x2"]
        assert "leaves 2 of 4" in r["mesh_1x2"]
        assert r["helpers"] == (rank, rank == 0, 4,
                                list(range(7))[rank::4])


def test_distributed_helpers_single_host(monkeypatch):
    from mvuld_tpu_torch.parallel.distributed import (
        is_primary, maybe_initialize_distributed, process_index,
        shard_manifest)
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert maybe_initialize_distributed() is False     # no torchrun env
    assert process_index() == 0 and is_primary()
    assert shard_manifest(list(range(7)), rank=1, world=3) == [1, 4]


@pytest.mark.parametrize("shift", [0, 2])
def test_sharded_attention_matches_jax(world4, shift):
    o0, l0, g0 = world4["jax_sp"][shift]
    for r in world4["res"]:
        out, loss, *grads = r["sp"][shift]
        np.testing.assert_allclose(out, o0, rtol=1e-5, atol=1e-5)
        # a sum of 8192 signed terms: bounded by the terms' own 1e-5
        assert abs(loss - l0) <= 1e-5 * np.abs(o0 * np.cos(o0)).sum()
        for a, b, name in zip(grads, g0, ("dqkv", "dbias", "dscale")):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def test_sharded_attention_rejects_indivisible_batch(world4):
    for r in world4["res"]:          # 3 images over 4 ranks
        assert "sequence-parallel" in r["sp_indivisible"]
        assert "multiple of the group size 4" in r["sp_indivisible"]


def test_model_level_sp_matches_xla_path(world4):
    """The tiny SwinV2 with the sharded kernel-path attention equals the
    JAX XLA path, and its gradients the unsharded kernel path's."""
    for r in world4["res"]:
        (sp, sp_grads), (plain, plain_grads) = r["sp_model"]
        np.testing.assert_allclose(sp, world4["sp_logits"], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(sp, plain, rtol=1e-6, atol=1e-6)
        for a, b in zip(sp_grads, plain_grads):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-6 * max(np.abs(b).max(), 1))


@pytest.mark.parametrize("case", range(len(MOE_CASES)),
                         ids=[f"top{k}_cf{cf}" for k, cf in MOE_CASES])
def test_moe_expert_parallel_world4_matches_jax(world4, case):
    _, _, y, aux = world4["moe"][case]
    got = np.concatenate([r["moe"][case]["y"] for r in world4["res"]])
    np.testing.assert_allclose(got, y.reshape(got.shape), atol=1e-5,
                               rtol=1e-5)
    for r in world4["res"]:
        assert abs(r["moe"][case]["aux"] - aux) < 1e-6


def test_tensor_parallel_sharding_matches_replicated(world4):
    """One AdamW step of a tiny SwinV2 on the (dp 2, mp 2) mesh, its
    weights split by JAX's name rules, equals the one-rank step: the loss
    (and JAX's), the global gradient norm, every parameter after the
    step; fc1, qkv, cpb_fc1 and proj really carry half their features."""
    for r in world4["res"]:
        tp = r["tp"]
        assert abs(tp["one"]["loss"] - world4["tp_jax_loss"]) < 1e-5
        assert abs(tp["tp"]["loss"] - tp["one"]["loss"]) < 1e-6
        assert abs(tp["tp"]["grad_norm"] - tp["one"]["grad_norm"]) < \
            1e-5 * tp["one"]["grad_norm"]
        assert max(tp["param_diff"].values()) < 1e-5, tp["param_diff"]
        sh = tp["shapes"]
        assert sh["layers.0.blocks.0.mlp.fc1.weight"] == (32, 16)
        assert sh["layers.0.blocks.0.mlp.fc2.weight"] == (16, 32)
        assert sh["layers.0.blocks.0.attn.qkv.weight"] == (24, 16)
        assert sh["layers.0.blocks.0.attn.proj.weight"] == (16, 8)
        assert sh["layers.0.blocks.0.attn.cpb_mlp.0.weight"] == (256, 2)
        assert sh["patch_embed.proj.weight"] == (16, 3, 4, 4)
        assert sh["layers.0.blocks.0.attn.cpb_mlp.2.weight"] == (2, 512)


def test_tp_spec_follows_the_jax_rules():
    from mvuld_tpu.parallel.mesh import tp_spec as jspec
    from mvuld_tpu_torch.parallel.mesh import tp_spec

    class K:
        def __init__(self, key):
            self.key = key

    paths = ["layers_0_blocks_0/attn/qkv_kernel", "layers_0_blocks_0/attn/"
             "proj/kernel", "layers_0_blocks_0/attn/proj/bias",
             "patch_embed/proj/kernel", "layers_0_blocks_0/mlp/fc1/kernel",
             "layers_0_blocks_0/mlp/fc1/bias", "layers_0_blocks_0/mlp/fc2/"
             "kernel", "layers_0_blocks_0/mlp/fc2/bias",
             "layers_0_blocks_0/attn/cpb_fc1/kernel",
             "layers_0_blocks_0/attn/cpb_fc2/kernel", "layer_0/intermediate/"
             "kernel", "layer_0/mlp_output/kernel", "norm/scale"]
    for path in paths:
        leaf = np.zeros((4, 4) if path.endswith("kernel") else (4,))
        want = jspec([K(p) for p in path.split("/")], leaf)
        got = tp_spec(path, leaf.ndim)
        expect = {None: (), "col": (None, "mp")[-leaf.ndim:],
                  "row": ("mp", None)}[got]
        assert tuple(want) == tuple(expect), path


# ------------------------------------------------------------ world 2

B_DP = 8
LR = 1e-3          # the workers' AdamW learning rate


ZOO_SIZES = dict(hidden=64, img_dim=40, text_dim=60, num_rs_gcn=2,
                 num_hidden=2, max_nodes=8)
TEXT = ["MODEL.UNIXCODER.LAYERS", "2", "MODEL.UNIXCODER.HIDDEN", "32",
        "MODEL.UNIXCODER.HEADS", "2", "MODEL.UNIXCODER.INTERMEDIATE", "64",
        "DATA.FUNC_TOKENS", "48", "PARALLEL.DTYPE", "float32",
        "TRAIN.EPOCHS", "1", "PRINT_FREQ", "1"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawned world of two ranks: data-parallel steps against one
    rank, a toy run that learns, the expert-parallel MoE with gradients,
    the ranks' dropout masks, and ``train_text.main`` at world 2."""
    from mvuld_tpu_torch.train.train_text import main as text_main

    rng = np.random.RandomState(7)
    node_emb, pos, adj, node_mask = _graph_inputs(rng, B_DP, 8, 60)
    zoo_batch = dict(img_emb=rng.randn(B_DP, 40).astype(np.float32),
                     text_emb=rng.randn(B_DP, 60).astype(np.float32),
                     node_emb=node_emb, pos=pos, adj=adj, node_mask=node_mask,
                     label=np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int32))
    x = np.random.RandomState(4).randn(B_DP, 16, 16, 3).astype(np.float32)
    _, flat, _ = _jax_swin(TP_SWIN, x, seed=6)
    swin_batch = dict(image=x, label=zoo_batch["label"])

    w_true = np.random.RandomState(0).randn(8)
    xs = np.random.RandomState(1).randn(32, 8).astype(np.float32)
    ys = (xs @ w_true > 0).astype(np.int32)

    moe_x = _moe_inputs()
    moe = [_jax_moe(k, cf, moe_x, seed=2 + i)
           for i, (k, cf) in enumerate(MOE_CASES)]

    run = tmp_path_factory.mktemp("text")
    tok = str(run / "tok.json")
    common = ["--synthetic", "24", "--batch-size", "8", "--tokenizer", tok,
              "--device", "cpu"]
    one = text_main([*common, "--test", "--output", str(run / "one"),
                     "--opts", *TEXT])
    argv_test = [*common, "--test", "--output", str(run / "two"),
                 "--opts", *TEXT]
    argv_train = [*common, "--output", str(run / "fit"), "--opts", *TEXT]

    res = run_local_world(
        workers.world2, 2,
        (functools.partial(workers.zoo_model, ZOO_SIZES), zoo_batch, "zoo"),
        (functools.partial(workers.swin_model, TP_SWIN, flat), swin_batch,
         "image"),
        (xs, ys), [(kw, p, moe_x, True) for kw, p, _, _ in moe],
        (argv_test, argv_train), timeout=WORLD_TIMEOUT)
    return dict(res=res, moe=moe, text_one=one, ys=ys, run=run)


@pytest.mark.parametrize("which", ["zoo", "swin"])
def test_dp_step_equals_one_rank(world2, which):
    """multi_defect_new_gcn (BatchNorm in every Rs-GCN block and the
    projections) and a tiny SwinV2: the world-2 step on 4 rows per rank
    equals the world-1 step on 8 rows — loss, gradients (averaged over dp
    before the clip), parameters after AdamW, BatchNorm statistics."""
    for r in world2["res"]:
        d = r[which]
        assert abs(d["dp"]["loss"] - d["one"]["loss"]) < 1e-6
        assert abs(d["dp"]["grad_norm"] - d["one"]["grad_norm"]) < \
            1e-5 * d["one"]["grad_norm"]
        (g1, g2), (sd1, sd2) = d["grads"], d["state"]
        for k, g in g1.items():
            scale = max(np.abs(g).max(), 1e-3)
            np.testing.assert_allclose(g2[k], g, rtol=0, atol=1e-5 * scale,
                                       err_msg=k)
            # AdamW's first update is lr·g/(|g| + eps): where an entry is
            # near zero a last-bit difference moves it by up to 2·lr, so
            # the 1e-5 bound holds where |g| > 1e-3 of the tensor's max
            sure = np.abs(g) > 1e-3 * scale
            np.testing.assert_allclose(sd2[k][sure], sd1[k][sure], rtol=0,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_allclose(sd2[k], sd1[k], rtol=0,
                                       atol=2 * LR + 1e-6, err_msg=k)
        stats = [k for k in sd1 if k not in g1]
        for k in stats:
            np.testing.assert_allclose(sd2[k], sd1[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        if which == "zoo":
            assert any("running_var" in k for k in stats)


def test_sharded_train_step_runs_and_learns(world2):
    losses0, logits, count = world2["res"][0]["toy"]
    losses1, logits1, _ = world2["res"][1]["toy"]
    assert losses0 == losses1                   # the global batch's loss
    assert losses0[-1] < losses0[0] * 0.7, losses0[:3] + losses0[-3:]
    assert float((logits.argmax(-1) == world2["ys"]).mean()) > 0.8
    np.testing.assert_array_equal(logits, logits1)
    assert count == 30


def test_dp_ranks_draw_distinct_dropout_masks(world2):
    """Dropout and DropPath masks are drawn per rank (``rank_seed``): the
    two ranks' masks differ, so dp parity is held at rate 0."""
    masks = world2["res"][0]["masks"]
    assert masks.shape == (2, 64) and not np.array_equal(masks[0], masks[1])


@pytest.mark.parametrize("case", range(len(MOE_CASES)),
                         ids=[f"top{k}_cf{cf}" for k, cf in MOE_CASES])
def test_moe_expert_parallel_world2(world2, case):
    """Two experts per rank: the output against JAX's global forward, and
    the gradients of x, of the rank's experts and (summed over ranks) of
    the gate against the one-rank MoE."""
    _, _, y, aux = world2["moe"][case]
    res = [r["moe"][case] for r in world2["res"]]
    got = np.concatenate([m["y"] for m in res])
    np.testing.assert_allclose(got, y.reshape(got.shape), atol=1e-5,
                               rtol=1e-5)
    for m in res:
        assert abs(m["aux"] - aux) < 1e-6
        for k in ("dx", "dw1", "dgate"):
            np.testing.assert_allclose(m[k], m[k + "_one"], atol=1e-5,
                                       rtol=1e-5, err_msg=k)


def test_train_text_dp_world2(world2):
    """``train_text.main`` at world 2: the sharded eval gathers the same
    test metrics as one rank, training runs, and only rank 0 writes."""
    one = world2["text_one"]["test_metrics"]
    for r in world2["res"]:
        got = r["text"][0]["test_metrics"]
        for k in ("acc", "f1", "pr_auc"):
            assert abs(got[k] - one[k]) < 1e-6, (k, got, one)
        fit = r["text"][1]
        assert fit["history"] and all(np.isfinite(h["f1"])
                                      for h in fit["history"])
    files = world2["res"][0]["text"][1]["files"]
    assert any(f.endswith("history.json") for f in files)
    assert not any("log_rank1" in f for f in files)


def test_torchrun_launches_a_trainer(tmp_path):
    """``torchrun --nproc-per-node 2 -m ...train_text`` on the CPU: the
    ranks join through torchrun's environment (gloo), train one epoch at
    PARALLEL.DP 2, and only rank 0 writes the run directory."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "mvuld_tpu_torch.train.train_text",
         "--synthetic", "24", "--batch-size", "8", "--output",
         str(tmp_path), "--device", "cpu", "--opts", *TEXT, "PARALLEL.DP",
         "2"], cwd=root, env=env, capture_output=True, text=True,
        timeout=WORLD_TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    files = [os.path.relpath(os.path.join(d, f), tmp_path)
             for d, _, fs in os.walk(tmp_path) for f in fs]
    assert any(f.endswith("history.json") for f in files), files
    assert any("log_rank0" in f for f in files)
    assert not any("log_rank1" in f for f in files)


# ------------------------------------------------------------ pipeline

PP_CFG = dict(vocab_size=97, hidden_size=32, num_layers=4, num_heads=2,
              intermediate_size=64, max_position_embeddings=64,
              dropout_rate=0.0)


def _pp_setup(B=8, T=12, seed=0, **over):
    from mvuld_tpu.models.roberta import RobertaConfig as JCfg
    from mvuld_tpu.models.roberta import RobertaEncoder as JEnc
    from mvuld_tpu_torch.models.roberta import RobertaConfig, RobertaEncoder
    cfg = {**PP_CFG, **over}
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, 97, (B, T)).astype(np.int32)
    ids[:, -2:] = 1                     # real padding in every row
    je = JEnc(JCfg(**cfg))
    params = je.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    pe = RobertaEncoder(RobertaConfig(**cfg))
    jax_variables_to_torch(_flatten({"params": params}), pe)
    return je, params, pe, ids


@pytest.mark.parametrize("stages,microbatches", [(2, 2), (2, 4), (4, 4)])
def test_pipeline_forward_matches_jax(stages, microbatches):
    from mvuld_tpu.parallel.pipeline import make_pp_mesh as jmesh
    from mvuld_tpu.parallel.pipeline import roberta_pipeline_forward as jpp
    from mvuld_tpu_torch.parallel.pipeline import (make_pp_mesh,
                                                   roberta_pipeline_forward)
    je, params, pe, ids = _pp_setup()
    want = np.asarray(jax.jit(lambda p, x: jpp(
        je.config, p, x, None, jmesh(stages), "pp", microbatches))(
        params, jnp.asarray(ids)))
    t = torch.as_tensor(ids).long()
    with torch.no_grad():
        got = roberta_pipeline_forward(pe, t, None, make_pp_mesh(stages),
                                       microbatches).numpy()
        seq = pe(t).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got, seq)     # the same layers, in order


@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_grad_matches_sequential(remat):
    """Gradients of every parameter (the stack and the embeddings) through
    the pipelined schedule against the sequential encoder's backward, and
    the embeddings' against JAX's sequential gradient."""
    from mvuld_tpu_torch.models.convert import torch_to_jax_names
    from mvuld_tpu_torch.parallel.pipeline import (make_pp_mesh,
                                                   roberta_pipeline_forward)
    je, params, pe, ids = _pp_setup(B=4)
    t = torch.as_tensor(ids).long()
    pp = roberta_pipeline_forward(pe, t, None, make_pp_mesh(4), 2,
                                  remat=remat)
    g_pp = torch.autograd.grad((pp.float() ** 2).mean(),
                               list(pe.parameters()))
    g_seq = torch.autograd.grad((pe(t).float() ** 2).mean(),
                                list(pe.parameters()))
    for a, b in zip(g_pp, g_seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-4)

    jg = jax.grad(lambda p: (je.apply({"params": p}, jnp.asarray(ids))
                             .astype(jnp.float32) ** 2).mean())(params)
    jflat = _flatten({"params": jg})
    names = torch_to_jax_names(pe)
    for (name, _), g in zip(pe.named_parameters(), g_pp):
        want = jflat[names[name]]
        got = g.numpy().T if names[name].endswith("/kernel") else g.numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4,
                                   err_msg=name)


def test_gpipe_generic_stack():
    from mvuld_tpu_torch.parallel.pipeline import gpipe, make_pp_mesh
    rng = np.random.RandomState(1)
    L, B, D = 4, 8, 16
    W = torch.as_tensor(rng.randn(L, D, D).astype(np.float32) * 0.3)
    x = torch.as_tensor(rng.randn(B, D).astype(np.float32))
    want = x
    for i in range(L):
        want = torch.tanh(want @ W[i])
    got = gpipe(lambda w, h, _, key: torch.tanh(h @ w), W, x, None,
                make_pp_mesh(4), 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-5)


def test_pipeline_validation_errors():
    from mvuld_tpu_torch.parallel.pipeline import gpipe, make_pp_mesh
    mesh = make_pp_mesh(4)
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="layers must divide"):
        gpipe(lambda w, h, _, k: h, torch.zeros(6, 4, 4), x, None, mesh, 4)
    with pytest.raises(ValueError, match="multiple of the"):
        gpipe(lambda w, h, _, k: h, torch.zeros(4, 4, 4), x, None, mesh, 3)


def test_pipeline_dropout_training():
    """Train-mode dropout keyed by (seed, microbatch, global layer):
    deterministic given the seed, different from the deterministic
    forward, the same across stage partitions, differentiable."""
    from mvuld_tpu_torch.parallel.pipeline import (make_pp_mesh,
                                                   roberta_pipeline_forward)
    _, _, pe, ids = _pp_setup(B=4, dropout_rate=0.3)
    t = torch.as_tensor(ids).long()
    with torch.no_grad():
        a = roberta_pipeline_forward(pe, t, None, make_pp_mesh(4), 2,
                                     dropout_rng=7)
        b = roberta_pipeline_forward(pe, t, None, make_pp_mesh(4), 2,
                                     dropout_rng=7)
        c = roberta_pipeline_forward(pe, t, None, make_pp_mesh(2), 2,
                                     dropout_rng=7)
        det = roberta_pipeline_forward(pe, t, None, make_pp_mesh(4), 2)
    assert torch.equal(a, b)
    assert not torch.allclose(a, det)
    np.testing.assert_allclose(c.numpy(), a.numpy(), atol=1e-6, rtol=1e-6)
    out = roberta_pipeline_forward(pe, t, None, make_pp_mesh(4), 2,
                                   remat=True, dropout_rng=7)
    np.testing.assert_allclose(out.detach().numpy(), a.numpy(), atol=1e-6)
    grads = torch.autograd.grad((out ** 2).mean(), list(pe.parameters()))
    total = sum(float(g.abs().sum()) for g in grads)
    assert np.isfinite(total) and total > 0


def test_stack_layer_params_roundtrip():
    from mvuld_tpu_torch.parallel.pipeline import stack_layer_params
    _, _, pe, _ = _pp_setup()
    stacked = stack_layer_params(dict(pe.named_parameters()), 4)
    leaf = stacked["attention.self.query.weight"]
    assert leaf.shape == (4, 32, 32) and leaf.requires_grad
    torch.testing.assert_close(
        leaf[2], pe.encoder.layer[2].attention.self.query.weight,
        rtol=0, atol=0)


# ------------------------------------------------------------ train_text PP

PP_OPTS = ["MODEL.UNIXCODER.LAYERS", "4", "MODEL.UNIXCODER.HIDDEN", "32",
           "MODEL.UNIXCODER.HEADS", "2", "MODEL.UNIXCODER.INTERMEDIATE",
           "64", "DATA.FUNC_TOKENS", "64", "DATA.BATCH_SIZE", "8",
           "TRAIN.EPOCHS", "2", "TRAIN.WARMUP_EPOCHS", "1",
           "PARALLEL.DTYPE", "float32", "PRINT_FREQ", "50"]
PIPE = ["PARALLEL.PP", "4", "PARALLEL.PP_MICROBATCHES", "2"]


def test_train_text_pp_runs(tmp_path):
    """PARALLEL.PP 4 × 2 microbatches trains; its checkpoint (the same
    parameter tree) loads into a sequential run and serves
    ``--save-embeddings``."""
    import pickle

    from mvuld_tpu_torch.core.checkpoint import load_checkpoint
    from mvuld_tpu_torch.train.train_text import main
    tok = str(tmp_path / "tok.json")
    common = ["--synthetic", "24", "--tokenizer", tok, "--device", "cpu"]
    res = main([*common, "--output", str(tmp_path / "pp"), "--opts",
                *PP_OPTS, *PIPE, "TRAIN.USE_CHECKPOINT", "True"])
    assert res["history"], "no validation history"
    assert all(np.isfinite(h["f1"]) for h in res["history"])
    assert np.isfinite(res["best_f1"])
    best = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "pp")
            for f in fs if f.startswith("best_f1_epoch")]
    assert len(best) >= 1
    best = max(best, key=os.path.getmtime)
    emb = tmp_path / "emb.pkl"
    seq = main([*common, "--output", str(tmp_path / "seq"),
                "--save-embeddings", str(emb), "--opts", *PP_OPTS,
                "TRAIN.EPOCHS", "0", "MODEL.RESUME", best])
    saved = load_checkpoint(best)["params"]
    for k, v in seq["model"].state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
        torch.testing.assert_close(res["model"].state_dict()[k], saved[k],
                                   rtol=0, atol=0)
    with open(emb, "rb") as f:
        reprs = pickle.load(f)
    assert len(reprs) == 24 and all(v.shape == (32,) for v in
                                    reprs.values())


def test_train_text_pp_eval_matches_jax(tmp_path, monkeypatch):
    """``--test`` on the seed-initialised parameters: the port's pipelined
    encoder, from JAX's initial variables, gives JAX's sequential metrics
    (the same tree, deterministic math, only the schedule differs)."""
    from mvuld_tpu.models.roberta import RobertaConfig as JCfg
    from mvuld_tpu.models.unixcoder import UniXcoderClassifier as JCls
    from mvuld_tpu.train.train_text import main as jmain
    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.data.tokenizer import vocab_size_of
    from mvuld_tpu_torch.models import convert
    from mvuld_tpu_torch.train.train_text import main as pmain

    tok = str(tmp_path / "tok.json")
    seq = jmain(["--synthetic", "24", "--test", "--tokenizer", tok,
                 "--output", str(tmp_path / "seq"), "--opts", *PP_OPTS])
    import argparse
    cfg = get_config(argparse.Namespace(opts=PP_OPTS))
    u = cfg.MODEL.UNIXCODER
    init = JCls(JCfg(vocab_size=max(vocab_size_of(tok), 16),
                     hidden_size=u.HIDDEN, num_layers=u.LAYERS,
                     num_heads=u.HEADS, intermediate_size=u.INTERMEDIATE,
                     max_position_embeddings=u.MAX_POSITIONS),
                num_classes=2).init(jax.random.PRNGKey(cfg.SEED),
                                    jnp.zeros((2, 64), jnp.int32))
    flat = _flatten(init)
    monkeypatch.setattr(convert, "init_jax_like",
                        lambda model, gen: jax_variables_to_torch(flat,
                                                                  model))
    pp = pmain(["--synthetic", "24", "--test", "--tokenizer", tok,
                "--output", str(tmp_path / "pp"), "--device", "cpu",
                "--opts", *PP_OPTS, *PIPE])
    for k in ("acc", "f1", "pr_auc"):
        assert abs(seq["test_metrics"][k] - pp["test_metrics"][k]) < 1e-6, \
            (k, seq["test_metrics"], pp["test_metrics"])
