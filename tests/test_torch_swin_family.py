"""The Swin family of the port (``models/{swin_v1,moe,swin_variants}.py``)
against the JAX package on the CPU, at narrow widths (embed 32, depths
2-2-2, 64² images, window 4: the last stage takes window = resolution,
shift 0).

- ``build_model``'s forward for each MODEL.TYPE: logits and pooled
  features (and the MoE's aux loss) within 1e-5 of JAX's on the same
  seeded variables (through ``jax_variables_to_torch``); the ``swin2``
  alias gives swinv2's model and outputs.
- One train-mode step (dropout, DropPath and gate noise 0): the loss
  within 1e-5 and every parameter gradient within relative L2 1e-4 of
  ``jax.grad`` (JAX's gradients through the converter).
- ``MoEFFN`` against JAX's: every token dispatched top_k times at a large
  capacity; top-2 slot offsets, dropped assignments at a small capacity
  and the aux loss at 1e-5; ties (equal logits) to the lowest expert.
- Dropout and DropPath come from the generator: equal seeds give equal
  outputs, other seeds other outputs, no generator none.
- ``build_model`` dispatch and the converter's key set both ways.
"""

import numpy as np
import pytest
import torch

from mvuld_tpu_torch.models.convert import (flatten_variables,
                                            jax_variables_to_torch,
                                            torch_to_jax_names)
from jax_reference import (no_persistent_compile_cache,  # noqa: F401
                           one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4          # relative L2, fp32
TYPES = ["swin", "swinv2", "swin_mlp", "swin_moe"]
IMG = 64
X = np.random.RandomState(1).randn(3, IMG, IMG, 3).astype(np.float32)
LABELS = np.array([0, 1, 1], np.int32)


def _cfg(mtype, package):
    if package == "jax":
        from mvuld_tpu.config import default_config
    else:
        from mvuld_tpu_torch.config import default_config
    cfg = default_config()
    cfg.MODEL.TYPE = mtype
    cfg.DATA.IMG_SIZE = IMG
    cfg.PARALLEL.DTYPE = "float32"
    cfg.MODEL.DROP_PATH_RATE = 0.0
    for sec in ("SWIN", "SWINV2", "SWIN_MOE", "SWIN_MLP"):
        s = cfg.MODEL[sec]
        s.EMBED_DIM = 32
        s.DEPTHS = [2, 2, 2]
        s.NUM_HEADS = [2, 4, 4]
        s.WINDOW_SIZE = 4
        if "PRETRAINED_WINDOW_SIZES" in s:
            s.PRETRAINED_WINDOW_SIZES = [0, 0, 0]
    cfg.MODEL.SWIN.APE = True            # V1's absolute position embedding
    m = cfg.MODEL.SWIN_MOE
    m.MOE_BLOCKS = [[1], [-1], [0, 1]]
    m.NUM_LOCAL_EXPERTS = 4
    m.GATE_NOISE = 0.0
    # what the JAX package computes: token-order slots, the GShard loss
    m.USE_BPR = False
    m.IS_GSHARD_LOSS = True
    return cfg


def _variables(jm, seed=0):
    """Every variable of ``jm``'s shapes drawn from numpy: kernels normal
    with std 1/√fan-in, LayerNorm scales near 1, biases, tables and
    embeddings small."""
    import jax
    import jax.numpy as jnp
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(X[:1])))
    flat = {"/".join(p.key for p in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in sorted(flat.items()):
        leaf = k.rsplit("/", 1)[-1]
        a = rng.randn(*shape)
        if leaf == "scale":
            a = 1.0 + 0.2 * a
        elif leaf == "logit_scale":
            a = np.log(10.0) + 0.3 * a
        elif len(shape) >= 2 and leaf != "absolute_pos_embed":
            fan_in = np.prod(shape[:-1]) if len(shape) == 4 else shape[-2]
            a = a / np.sqrt(fan_in)
        else:
            a = 0.05 * a
        out[k] = a.astype(np.float32)
    return out


def _unflatten(flat):
    import jax.numpy as jnp
    tree = {}
    for k, v in flat.items():
        d = tree
        *path, last = k.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[last] = jnp.asarray(v)
    return tree


def _models(mtype):
    from mvuld_tpu.models.swin_variants import build_model as jbuild
    from mvuld_tpu_torch.models.swin_variants import build_model
    jm = jbuild(_cfg(mtype, "jax"))
    flat = _variables(jm)
    pm = build_model(_cfg(mtype, "torch"))
    jax_variables_to_torch(flat, pm)
    return jm, pm, flat


def _split(out):
    return out if isinstance(out, tuple) else (out, None)


@pytest.mark.parametrize("mtype", TYPES)
def test_forward_matches_jax(mtype):
    """Eval logits and pooled features (and the MoE's aux)."""
    import jax
    import jax.numpy as jnp
    jm, pm, flat = _models(mtype)
    fn = jax.jit(lambda v, x: (jm.apply(v, x),
                               jm.apply(v, x, return_features=True)))
    want = [_split(o) for o in fn(_unflatten(flat), jnp.asarray(X))]
    with torch.no_grad():
        got = [_split(pm(torch.as_tensor(X), return_features=f))
               for f in (False, True)]
    for (g, aux), (w, jaux) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)
        assert (aux is None) == (jaux is None)
        if jaux is not None:
            np.testing.assert_allclose(float(aux), float(jaux), **FWD_TOL)
    assert got[0][0].shape == (3, 2) and got[1][0].shape == (3, 128)


def test_swin2_alias():
    """MODEL.TYPE 'swin2' builds swinv2's model: the same parameters and,
    on the same weights, the same logits."""
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.swin_variants import build_model
    a, b = build_model(_cfg("swin2", "torch")), build_model(
        _cfg("swinv2", "torch"))
    init_jax_like(a, torch.Generator().manual_seed(0))
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(a(torch.as_tensor(X)),
                                   b(torch.as_tensor(X)), atol=0, rtol=0)


@pytest.mark.parametrize("mtype", TYPES)
def test_train_step_matches_jax(mtype):
    """One train-mode step: CE (+ the MoE's aux) and its gradients."""
    import jax
    import jax.numpy as jnp

    from mvuld_tpu.core.train_state import cross_entropy as jce
    from mvuld_tpu_torch.core.train_state import cross_entropy
    jm, pm, flat = _models(mtype)
    params = _unflatten(flat)["params"]

    def loss_fn(p):
        logits, aux = _split(jm.apply(
            {"params": p}, jnp.asarray(X), deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(3)}))
        loss = jce(logits, jnp.asarray(LABELS), 0.0)
        return loss + (0.0 if aux is None else aux), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    gen = torch.Generator().manual_seed(0)
    logits, aux = _split(pm(torch.as_tensor(X), train=True, gen=gen))
    loss = cross_entropy(logits, torch.as_tensor(LABELS).long(), 0.0)
    if aux is not None:
        loss = loss + aux
    names, ps = zip(*pm.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **FWD_TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)

    from mvuld_tpu_torch.models.swin_variants import build_model
    ref = build_model(_cfg(mtype, "torch"))
    jax_variables_to_torch(
        {"params/" + k: np.asarray(a)
         for k, a in flatten_variables(jgrads).items()}, ref)
    want = ref.state_dict()
    for name, g in zip(names, grads):
        w = want[name].double()
        err = float((g.double() - w).norm() / w.norm().clamp_min(1e-30))
        assert err <= GRAD_TOL, (name, err)


def test_converter_key_sets():
    """Every variable of the three new models maps to one port tensor and
    back (``torch_to_jax_names`` is the inverse)."""
    for mtype in ("swin", "swin_mlp", "swin_moe"):
        _, pm, flat = _models(mtype)
        assert sorted(torch_to_jax_names(pm).values()) == sorted(flat)
        with pytest.raises(KeyError, match="unused"):
            jax_variables_to_torch({**flat, "params/bogus/kernel":
                                    np.zeros((2, 2), np.float32)}, pm)
        some = sorted(flat)[0]
        with pytest.raises(KeyError, match="unset"):
            jax_variables_to_torch({k: v for k, v in flat.items()
                                    if k != some}, pm)


def test_build_model_dispatch():
    from mvuld_tpu_torch.models.swin_v1 import SwinTransformerV1
    from mvuld_tpu_torch.models.swin_v2 import SwinTransformerV2
    from mvuld_tpu_torch.models.swin_variants import (SwinMLP,
                                                      SwinTransformerMoE,
                                                      build_model)
    want = {"swin": SwinTransformerV1, "swinv2": SwinTransformerV2,
            "swin2": SwinTransformerV2, "swin_mlp": SwinMLP,
            "swin_moe": SwinTransformerMoE}
    for mtype, cls in want.items():
        assert type(build_model(_cfg(mtype, "torch"))) is cls, mtype
    cfg = _cfg("swinv2", "torch")
    cfg.TRAIN.USE_CHECKPOINT = True
    cfg.TRAIN.FUSED_MLP = True
    m = build_model(cfg, kernels=True)
    assert m.remat_stages == (0, 1, 2)
    blk = m.layers[0].blocks[0]
    assert blk.attn.use_pallas and blk.use_pallas_mlp
    assert m.head.out_features == 2
    moe = build_model(_cfg("swin_moe", "torch"))
    assert [len(moe.moe_layers()), moe.moe_layers()[0].num_experts] == [3, 4]
    cfg = _cfg("swin", "torch")
    cfg.MODEL.TYPE = "swin3"
    with pytest.raises(KeyError):
        build_model(cfg)


# ------------------------------------------------------------------ MoEFFN

def _moe_pair(top_k, capacity_factor, T=24, D=8, E=4, seed=0, zero_gate=False):
    import jax
    import jax.numpy as jnp

    from mvuld_tpu.models.moe import MoEFFN as JMoE
    from mvuld_tpu_torch.models.moe import MoEFFN
    x = np.random.RandomState(seed).randn(2, T // 2, D).astype(np.float32)
    jm = JMoE(hidden=16, out=D, num_experts=E, top_k=top_k,
              capacity_factor=capacity_factor, gate_noise=0.0)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    flat = {k: np.asarray(a) for k, a in flatten_variables(v).items()}
    if zero_gate:
        flat["params/gate"] = np.zeros_like(flat["params/gate"])
    rng = np.random.RandomState(seed + 1)
    for k in ("params/b1", "params/b2"):
        flat[k] = (0.1 * rng.randn(*flat[k].shape)).astype(np.float32)
    pm = MoEFFN(D, 16, D, E, top_k, capacity_factor, gate_noise=0.0)
    pm.load_state_dict({k.split("/")[-1]: torch.as_tensor(a)
                        for k, a in flat.items()})
    return jm, pm, _unflatten(flat), x


@pytest.mark.parametrize("top_k,cf", [(1, 4.0), (2, 4.0), (2, 1.0),
                                      (1, 0.25), (2, 0.25)],
                         ids=["top1_roomy", "top2_roomy", "top2_cf1",
                              "top1_drops", "top2_drops"])
def test_moe_matches_jax(top_k, cf):
    """Output, aux and the input and parameter gradients against JAX;
    how many assignments a capacity drops."""
    import jax
    import jax.numpy as jnp
    jm, pm, v, x = _moe_pair(top_k, cf)

    def f(params, xx):
        y, aux = jm.apply({"params": params}, xx)
        return (y * y).sum() + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    y, aux = pm(xt)
    gx, *gp = torch.autograd.grad((y * y).sum() + aux, [xt] + [
        getattr(pm, n) for n in ("gate", "w1", "b1", "w2", "b2")])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **FWD_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **FWD_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **FWD_TOL)
    for name, g in zip(("gate", "w1", "b1", "w2", "b2"), gp):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    experts, keep = pm.routing
    T = x.shape[0] * x.shape[1]
    C = pm.capacity(T)
    assert experts.shape == keep.shape == (top_k, T)
    # every expert holds at most C assignments, and the kept ones first
    flat_e = experts[keep]
    assert torch.bincount(flat_e, minlength=4).max() <= C
    if cf >= 4.0:
        assert bool(keep.all())          # every token dispatched top_k times
    if cf == 0.25:
        assert int((~keep).sum()) > 0
    if top_k == 2:
        assert bool((experts[0] != experts[1]).all())


def test_moe_ties_to_lowest_expert():
    """Equal logits (a zero gate): top-1 picks expert 0 and top-2 experts
    0 and 1, as ``jax.lax.top_k`` / ``jnp.argmax``; the outputs equal
    JAX's, with expert 0's capacity overflowing."""
    import jax
    for top_k in (1, 2):
        jm, pm, v, x = _moe_pair(top_k, 1.0, zero_gate=True)
        jy, jaux = jax.jit(jm.apply)(v, x)
        y, aux = pm(torch.as_tensor(x))
        experts, keep = pm.routing
        assert experts[0].eq(0).all()
        if top_k == 2:
            assert experts[1].eq(1).all()
        assert int(keep.sum()) == top_k * pm.capacity(x.shape[0] * x.shape[1])
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   **FWD_TOL)
        np.testing.assert_allclose(float(aux), float(jaux), **FWD_TOL)


def test_moe_gate_noise_from_generator():
    """Training noise comes from the generator: the same seed routes the
    same way, and no generator adds no noise."""
    from mvuld_tpu_torch.models.moe import MoEFFN
    x = torch.as_tensor(np.random.RandomState(0).randn(64, 8),
                        dtype=torch.float32)
    from mvuld_tpu_torch.models.convert import init_jax_like
    pm = MoEFFN(8, 16, 8, 4, 1, 2.0, gate_noise=40.0)
    init_jax_like(pm, torch.Generator().manual_seed(0))
    base, route = pm(x)[0], pm.routing[0]
    noisy, routes = [], []
    for seed in (1, 1, 2):
        noisy.append(pm(x, gen=torch.Generator().manual_seed(seed))[0])
        routes.append(pm.routing[0])
    torch.testing.assert_close(noisy[0], noisy[1], atol=0, rtol=0)
    assert torch.equal(routes[0], routes[1])
    assert not torch.equal(routes[0], routes[2])
    assert not torch.equal(routes[0], route)
    torch.testing.assert_close(pm(x)[0], base, atol=0, rtol=0)


# ------------------------------------------------------------- generators

@pytest.mark.parametrize("mtype", ["swin", "swin_mlp", "swin_moe"])
def test_dropout_and_droppath_from_generator(mtype):
    """With MODEL.DROP_RATE 0.2 and DROP_PATH_RATE 0.3: equal seeds give
    equal logits, other seeds other logits; train without a generator and
    eval drop nothing."""
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.swin_variants import build_model
    cfg = _cfg(mtype, "torch")
    cfg.MODEL.DROP_RATE = 0.2
    cfg.MODEL.DROP_PATH_RATE = 0.3
    m = build_model(cfg)
    init_jax_like(m, torch.Generator().manual_seed(0))
    x = torch.as_tensor(X)

    def run(seed=None, train=True):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return _split(m(x, train=train, gen=gen))[0]

    a, b, c = run(5), run(5), run(6)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, c)
    torch.testing.assert_close(run(None), run(None, train=False),
                               atol=0, rtol=0)
    assert not torch.allclose(a, run(None, train=False))
