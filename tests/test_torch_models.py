"""Parity of the PyTorch port's models with the JAX package on the CPU.

Each test draws one set of variables from a numpy seed (non-trivial biases,
logit scales and BatchNorm statistics), runs the JAX module on them, loads
them into the port through ``jax_variables_to_torch`` and compares the
outputs at fp32. Tolerance 1e-4 (absolute and relative): both sides compute
in fp32 with different summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvuld_tpu_torch.models.convert import jax_variables_to_torch
from jax_reference import no_persistent_compile_cache  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _random_variables(model, args, kwargs, seed):
    """Variables of ``model``'s shapes drawn from numpy, flattened with '/'
    keys. Variances stay positive; logit scales sit near log 10."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *args, **kwargs))
    flat = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(flat.items()):
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "var":
            a = rng.uniform(0.5, 1.5, s.shape)
        elif leaf == "logit_scale":
            a = np.log(10.0) + 0.3 * rng.randn(*s.shape)
        elif leaf in ("scale", "mean"):
            a = (leaf == "scale") + 0.2 * rng.randn(*s.shape)
        else:
            a = 0.2 * rng.randn(*s.shape)
        out[k] = a.astype(np.float32)
    return out


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        d = tree
        *path, last = k.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[last] = jnp.asarray(v)
    return tree


def _jax_apply(model, flat, *args, **kwargs):
    fn = jax.jit(lambda v, *a: model.apply(v, *a, **kwargs))
    return np.asarray(fn(_unflatten(flat), *args))


# ---------------------------------------------------------------- SwinV2

SWIN = dict(img_size=32, patch_size=2, embed_dim=16, depths=(2, 2, 2),
            num_heads=(2, 2, 4), window_size=4,
            pretrained_window_sizes=(0, 0, 3))


@pytest.mark.parametrize("kernels", [False, True],
                         ids=["xla_numerics", "kernel_numerics"])
def test_swin_v2_matches_jax(kernels):
    """Scan-layout variables, shifted blocks in stages 1-2 (window grids
    4×4 and 2×2), the window clamped in stage 3. ``xla_numerics`` holds the
    plain blocks against the JAX XLA branch (exact softmax, /max(‖q‖,
    1e-12)); ``kernel_numerics`` holds the port's kernel path (plain K1/K3
    on the CPU) against the Pallas kernels in interpret mode (rsqrt
    normalisation, fixed softmax shift, in-kernel shift mask, fused MLP)."""
    from mvuld_tpu.models.swin_v2 import PallasOpts
    from mvuld_tpu.models.swin_v2 import SwinTransformerV2 as JSwin
    from mvuld_tpu.models.swin_v2 import SwinV2Config as JCfg
    from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                SwinV2Config)

    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    jm = JSwin(JCfg(**SWIN), scan_blocks=True, use_pallas=kernels,
               use_pallas_mlp=kernels,
               pallas_opts=PallasOpts(interpret=True) if kernels else None)
    flat = _random_variables(jm, (jnp.asarray(x),),
                             dict(return_features=True), seed=2)
    assert any("_scan/" in k for k in flat)
    ref = _jax_apply(jm, flat, jnp.asarray(x), return_features=True)

    pm = SwinTransformerV2(SwinV2Config(**SWIN), use_pallas=kernels,
                           use_pallas_mlp=kernels)
    jax_variables_to_torch(flat, pm)
    with torch.no_grad():
        out = pm(torch.as_tensor(x)).numpy()
    assert out.shape == (2, 64)
    np.testing.assert_allclose(out, ref, **TOL)


# ---------------------------------------------------------------- RoBERTa

ROBERTA = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               intermediate_size=128, max_position_embeddings=40)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_roberta_encoder_matches_jax(fused):
    """Padded rows; ``fused`` holds the port's K4 path (plain on the CPU)
    against the Pallas ``mlp_ln_res`` in interpret mode."""
    from mvuld_tpu.models.roberta import RobertaConfig as JCfg
    from mvuld_tpu.models.roberta import RobertaEncoder as JEnc
    from mvuld_tpu_torch.models.roberta import RobertaConfig, RobertaEncoder

    rng = np.random.RandomState(3)
    ids = rng.randint(3, 64, (3, 24)).astype(np.int32)
    ids[0, 17:] = 1
    ids[2, 5:] = 1
    mask = (ids != 1).astype(np.int32)
    jm = JEnc(JCfg(**ROBERTA, use_pallas_mlp=fused, pallas_interpret=fused))
    flat = _random_variables(jm, (jnp.asarray(ids), jnp.asarray(mask)), {},
                             seed=4)
    ref = _jax_apply(jm, flat, jnp.asarray(ids), jnp.asarray(mask))

    pm = RobertaEncoder(RobertaConfig(**ROBERTA, use_pallas_mlp=fused))
    jax_variables_to_torch(flat, pm)
    with torch.no_grad():
        out = pm(torch.as_tensor(ids).long(), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


# ---------------------------------------------------------------- fusion

def _graph_inputs(rng, B, N, D):
    node_mask = np.zeros((B, N), np.float32)
    for b in range(B):
        node_mask[b, : rng.randint(2, N + 1)] = 1.0
    adj = rng.rand(B, N, N) < 0.3
    adj |= np.eye(N, dtype=bool)[None]
    adj &= (node_mask[:, :, None] > 0) & (node_mask[:, None, :] > 0)
    node_emb = rng.randn(B, N, D).astype(np.float32) * node_mask[..., None]
    pos = rng.rand(B, N, 4).astype(np.float32) * node_mask[..., None]
    return node_emb, pos, adj, node_mask


def test_fusion_head_matches_jax():
    """``multi_defect_new_gcn`` in eval mode with non-trivial batch_stats
    (node-axis BN, Rs-GCN BN, projections, final BN)."""
    from mvuld_tpu.models.fusion_zoo import build_fusion_model
    from mvuld_tpu_torch.models.fusion_zoo import MultiDefectAblation

    rng = np.random.RandomState(5)
    B, N, D, I = 3, 8, 24, 20
    node_emb, pos, adj, node_mask = _graph_inputs(rng, B, N, D)
    img = rng.randn(B, I).astype(np.float32)
    text = rng.randn(B, D).astype(np.float32)
    jm = build_fusion_model(None, "multi_defect_new_gcn", hidden=64,
                            img_dim=I, text_dim=D, num_rs_gcn=2, num_hidden=2)
    args = tuple(jnp.asarray(a) for a in (img, text, node_emb, pos, adj,
                                          node_mask))
    flat = _random_variables(jm, args, dict(train=False), seed=6)
    assert any(k.startswith("batch_stats/graph/rs_gcn_") for k in flat)
    ref = _jax_apply(jm, flat, *args, train=False)

    pm = MultiDefectAblation(hidden=64, img_dim=I, text_dim=D, num_rs_gcn=2,
                             num_hidden=2, max_nodes=N)
    jax_variables_to_torch(flat, pm)
    pm.eval()
    with torch.no_grad():
        out = pm(*(torch.as_tensor(a) for a in (img, text, node_emb, pos,
                                                adj, node_mask))).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


# ---------------------------------------------------------------- e2e

E2E_OPTS = [
    "MODEL.UNIXCODER.LAYERS", "1", "MODEL.UNIXCODER.HIDDEN", "32",
    "MODEL.UNIXCODER.HEADS", "2", "MODEL.UNIXCODER.INTERMEDIATE", "128",
    "MODEL.SWINV2.EMBED_DIM", "16", "MODEL.SWINV2.DEPTHS", "[2, 2]",
    "MODEL.SWINV2.NUM_HEADS", "[2, 2]", "MODEL.SWINV2.WINDOW_SIZE", "4",
    "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", "[0, 0]",
    "DATA.IMG_SIZE", "32", "DATA.FUNC_TOKENS", "24", "DATA.NODE_TOKENS", "8",
    "DATA.MAX_NODES", "6", "MODEL.MULTI.HIDDEN", "64",
    "MODEL.MULTI.NUM_RS_GCN", "1", "MODEL.MULTI.NUM_HIDDEN_FC", "1",
    "PARALLEL.DTYPE", "float32",
]


def _cfgs():
    from types import SimpleNamespace

    from mvuld_tpu.config import get_config as jget
    from mvuld_tpu_torch.config import get_config as pget
    ns = SimpleNamespace(cfg=None, opts=E2E_OPTS, output="unused")
    return jget(ns), pget(ns)


def _e2e_inputs(B, cfg):
    rng = np.random.RandomState(7)
    M, T, Tn, S = (cfg.DATA.MAX_NODES, cfg.DATA.FUNC_TOKENS,
                   cfg.DATA.NODE_TOKENS, cfg.DATA.IMG_SIZE)
    func_ids = rng.randint(3, 50, (B, T)).astype(np.int32)
    func_ids[:, T // 2:] = 1
    node_ids = rng.randint(3, 50, (B, M, Tn)).astype(np.int32)
    node_ids[..., 5:] = 1
    _, pos, adj, node_mask = _graph_inputs(rng, B, M, 4)
    node_ids[node_mask == 0] = 1
    image = rng.randn(B, S, S, 3).astype(np.float32)
    return dict(func_ids=func_ids, node_ids=node_ids, image=image, pos=pos,
                adj=adj, node_mask=node_mask)


@pytest.mark.parametrize("capacity", [None, 5], ids=["unpacked", "packed"])
def test_e2e_matches_jax(capacity):
    """EndToEndMVulD with the plain layers on both sides (XLA numerics),
    every line slot encoded or the valid lines packed into 5 rows (below
    the batch's valid count, so overflow lines get zero embeddings)."""
    from mvuld_tpu.train.train_e2e import build_e2e_model as jbuild
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model as pbuild

    jcfg, pcfg = _cfgs()
    inp = _e2e_inputs(2, jcfg)
    jm, _, _ = jbuild(jcfg, 50, node_capacity=capacity, scan_blocks=True)
    jargs = {k: jnp.asarray(v) for k, v in inp.items()}
    flat = _random_variables(jm, (), dict(**jargs, train=False), seed=8)
    ref = np.asarray(jax.jit(lambda v, a: jm.apply(v, **a, train=False))(
        _unflatten(flat), jargs))

    pm, _, _ = pbuild(pcfg, 50, node_capacity=capacity)
    jax_variables_to_torch(flat, pm)
    pm.eval()
    with torch.no_grad():
        out = pm(*(torch.as_tensor(inp[k]) for k in
                   ("func_ids", "node_ids", "image", "pos", "adj",
                    "node_mask"))).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_converter_raises_on_unused_and_unset():
    from mvuld_tpu_torch.models.fusion_zoo import MultiDefectAblation

    pm = MultiDefectAblation(hidden=64, img_dim=8, text_dim=8, num_rs_gcn=1,
                             num_hidden=1, max_nodes=4)
    with pytest.raises(KeyError, match="unused"):
        jax_variables_to_torch({"params/nope/kernel": np.zeros((2, 2))}, pm)
    with pytest.raises(KeyError, match="unset"):
        jax_variables_to_torch({"params/final_fc/bias": np.zeros(2)}, pm)
