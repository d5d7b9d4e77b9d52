"""The port's checkpoint converters against the JAX package's on the CPU.

Each case builds a reference-layout torch state dict from a seeded port
model, converts it with both packages and compares the port tensors: the
JAX result (a Flax tree) goes through ``flatten_variables`` and
``jax_variables_to_torch`` into a second port model.

- ``load_unixcoder_checkpoint`` on the three layouts (bare RobertaModel,
  the cunixcoder DefectModel under ``encoder.`` / ``roberta.``, either
  under DataParallel's ``module.``): equal encoder tensors, classifier and
  layer count; a missing tensor raises.
- ``fusion_torch_to_port`` against ``fusion_torch_to_flax`` for zoo keys
  with GAT + Rs-GCN, the GRU readout (biases folded), the dot fusion and
  the deep bbox path: equal tensors; unused and missing keys raise.
- ``convert_checkpoint swinv2`` / ``roberta`` against the JAX CLI's orbax
  output: equal tensors; the SwinV2 output loads as ``pipeline
  --swin-ckpt DIR`` finds it, with JAX's logits (1e-5).
- The SwinV1 bias-table resample (window 7 → 12, ``F.interpolate``
  bicubic) within 1e-4 of JAX's cv2 branch, and
  ``convert_swinv1_state_dict`` against ``swinv1_torch_to_flax`` with the
  22k → 1k head and with a re-initialised one.
Tolerance: exact for copies, 1e-4 for resampled tables (cv2 tabulates its
cubic weights), 1e-5 for logits.
"""

import os

import numpy as np
import pytest
import torch

from mvuld_tpu_torch.models.convert import (flatten_variables, init_jax_like,
                                            jax_variables_to_torch)
from jax_reference import no_persistent_compile_cache  # noqa: F401

RESAMPLE_TOL = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _via_jax(tree, model, prefix="params/"):
    """A Flax params tree → ``model``'s state dict through the converter."""
    flat = {prefix + k: v for k, v in flatten_variables(_np_tree(tree)).items()}
    jax_variables_to_torch(flat, model)
    return model.state_dict()


def _assert_same(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **(tol or dict(atol=0, rtol=0)))


# ------------------------------------------------------------- UniXcoder

def _roberta(layers=2):
    from mvuld_tpu_torch.models.roberta import RobertaConfig, RobertaEncoder
    m = RobertaEncoder(RobertaConfig(
        vocab_size=40, hidden_size=16, num_layers=layers, num_heads=2,
        intermediate_size=32, max_position_embeddings=24))
    init_jax_like(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    return m


def _hf_state(enc, prefix=""):
    """A HF RobertaModel state dict: the encoder's, a pooler and the
    position-id buffer."""
    sd = {prefix + k: v.clone() for k, v in enc.state_dict().items()}
    sd[prefix + "pooler.dense.weight"] = torch.ones(16, 16)
    sd[prefix + "pooler.dense.bias"] = torch.zeros(16)
    sd[prefix + "embeddings.position_ids"] = torch.arange(24)[None]
    return sd


@pytest.mark.parametrize("layout", ["bare", "defect", "roberta",
                                    "module_bare", "module_defect"])
def test_load_unixcoder_checkpoint_matches_jax(layout):
    from mvuld_tpu.utils.torch_convert import \
        load_unixcoder_checkpoint as jload
    from mvuld_tpu_torch.models.roberta import RobertaEncoder
    from mvuld_tpu_torch.utils.torch_convert import load_unixcoder_checkpoint
    enc = _roberta()
    prefix = {"bare": "", "defect": "encoder.", "roberta": "roberta.",
              "module_bare": "", "module_defect": "encoder."}[layout]
    sd = _hf_state(enc, prefix)
    if layout in ("defect", "module_defect"):
        sd["classifier.weight"] = torch.randn(2, 16)
        sd["classifier.bias"] = torch.randn(2)
    if layout.startswith("module_"):
        sd = {"module." + k: v for k, v in sd.items()}
    got, cls, n = load_unixcoder_checkpoint(sd)
    jenc, jcls, jn = jload({k: v.numpy() for k, v in sd.items()})
    assert n == jn == 2
    want = _via_jax(jenc, RobertaEncoder(enc.config))
    _assert_same(got, want)
    _assert_same(got, enc.state_dict())
    assert (cls is None) == (jcls is None)
    if cls is not None:
        np.testing.assert_array_equal(cls["weight"].numpy(),
                                      np.asarray(jcls["kernel"]).T)
        np.testing.assert_array_equal(cls["bias"].numpy(), jcls["bias"])
    del sd[next(k for k in sd if k.endswith("layer.1.output.dense.bias"))]
    with pytest.raises(KeyError, match="unset"):
        load_unixcoder_checkpoint(sd)


# ---------------------------------------------------------------- fusion

FUSION_KEYS = ["multi_defect_new_gcn", "multi_defect_grudot",
               "multi_defect_noglobalimage", "multi_defect_nogat3",
               "motivation_image"]


def _reference_state(pm, seed=0):
    """The reference class's state dict of a seeded port fusion head (the
    inverse of ``reference_modules``), with random hidden biases on the
    GRU's r and z gates (folded into the input biases on the way in)."""
    from mvuld_tpu_torch.models.fusion_convert import reference_modules
    rng = torch.Generator().manual_seed(seed)
    sd = pm.state_dict()
    out = {}
    for port, ref, kind in reference_modules(pm):
        leaves = {k[len(port) + 1:]: v for k, v in sd.items()
                  if k.startswith(port + ".")}
        if kind == "gru":
            w = {k: leaves[k] for k in leaves}
            b_hr, b_hz = (torch.randn(w["hr.weight"].shape[0], generator=rng)
                          for _ in range(2))
            out[f"{ref}.weight_ih_l0"] = torch.cat(
                [w["ir.weight"], w["iz.weight"], w["in.weight"]])
            out[f"{ref}.weight_hh_l0"] = torch.cat(
                [w["hr.weight"], w["hz.weight"], w["hn.weight"]])
            out[f"{ref}.bias_ih_l0"] = torch.cat(
                [w["ir.bias"] - b_hr, w["iz.bias"] - b_hz, w["in.bias"]])
            out[f"{ref}.bias_hh_l0"] = torch.cat([b_hr, b_hz, w["hn.bias"]])
        else:
            for k, v in leaves.items():
                out[f"{ref}.{k}"] = v.clone()
    return out


@pytest.mark.parametrize("key", FUSION_KEYS)
def test_fusion_torch_to_port_matches_jax(key):
    from test_torch_fusion_zoo import _models

    from mvuld_tpu.models.fusion_convert import fusion_torch_to_flax
    from mvuld_tpu_torch.models.fusion_convert import fusion_torch_to_port
    jm, pm = _models(key)
    init_jax_like(pm, torch.Generator().manual_seed(1))
    with torch.no_grad():                 # non-trivial BN statistics
        for name, b in pm.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(len(name)))
    sd = _reference_state(pm)
    got = fusion_torch_to_port(sd, _models(key)[1])
    tree = fusion_torch_to_flax({k: v.numpy() for k, v in sd.items()}, jm)
    _, ref = _models(key)
    flat = {f"{coll}/{k}": v for coll in ("params", "batch_stats")
            for k, v in flatten_variables(_np_tree(tree[coll])).items()}
    jax_variables_to_torch(flat, ref)
    # GRU biases fold in fp32: both sides add the same two floats
    _assert_same(got, ref.state_dict())
    if key == "multi_defect_grudot":
        _assert_same(got, pm.state_dict(), atol=1e-6, rtol=1e-6)
    with pytest.raises(KeyError, match="unused"):
        fusion_torch_to_port({**sd, "extra.weight": torch.zeros(1)},
                             _models(key)[1])
    with pytest.raises(KeyError, match="final_fc"):
        fusion_torch_to_port({k: v for k, v in sd.items()
                              if not k.startswith("final_fc")},
                             _models(key)[1])


# ------------------------------------------------------ convert_checkpoint

SWIN_FLAGS = ["--img-size", "64", "--window", "4", "--embed-dim", "16",
              "--depths", "2,2", "--heads", "2,4", "--pretrained-windows",
              "2,2", "--num-classes", "2"]


def _swin_source(tmp_path):
    """A reference-layout SwinV2 .pth at 32², window 2, five classes."""
    from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                SwinV2Config)
    src = SwinTransformerV2(SwinV2Config(
        img_size=32, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
        window_size=2), num_classes=5)
    init_jax_like(src, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel() + 1)))
    sd = dict(src.state_dict())
    sd.update(dict(src.named_buffers()))
    path = str(tmp_path / "src.pth")
    torch.save({"model": sd}, path)
    return path


def test_convert_checkpoint_swinv2_matches_jax(tmp_path):
    import jax.numpy as jnp

    from mvuld_tpu.core.checkpoint import load_checkpoint as jload
    from mvuld_tpu.models.swin_v2 import SwinTransformerV2 as JSwin
    from mvuld_tpu.models.swin_v2 import SwinV2Config as JCfg
    from mvuld_tpu.tools.convert_checkpoint import main as jmain
    from mvuld_tpu_torch.core.checkpoint import load_checkpoint
    from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                SwinV2Config)
    from mvuld_tpu_torch.tools.convert_checkpoint import main as pmain
    from mvuld_tpu_torch.train.pipeline import _swin_checkpoint
    src = _swin_source(tmp_path)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpath = jmain(["swinv2", src, jdir, *SWIN_FLAGS]) or os.path.join(
        jdir, "checkpoints", "ckpt_epoch_0")
    ppath = pmain(["swinv2", src, pdir, *SWIN_FLAGS, "--scan-layout"])
    cfg = SwinV2Config(img_size=64, embed_dim=16, depths=(2, 2),
                       num_heads=(2, 4), window_size=4,
                       pretrained_window_sizes=(2, 2))
    jparams = jload(jpath)["params"]
    want = _via_jax(jparams, SwinTransformerV2(cfg, num_classes=2))
    assert _swin_checkpoint(pdir) == ppath
    got = load_checkpoint(_swin_checkpoint(pdir))["params"]
    _assert_same(got, want)
    # pipeline --swin-ckpt DIR's load, then JAX's logits on the same input
    model = SwinTransformerV2(cfg, num_classes=2)
    model.load_state_dict(got)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    jm = JSwin(JCfg(img_size=64, embed_dim=16, depths=(2, 2),
                    num_heads=(2, 4), window_size=4,
                    pretrained_window_sizes=(2, 2), num_classes=2))
    ref = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        out = model(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_convert_checkpoint_roberta_matches_jax(tmp_path):
    from mvuld_tpu.core.checkpoint import load_checkpoint as jload
    from mvuld_tpu.tools.convert_checkpoint import main as jmain
    from mvuld_tpu_torch.core.checkpoint import load_checkpoint
    from mvuld_tpu_torch.models.roberta import RobertaEncoder
    from mvuld_tpu_torch.tools.convert_checkpoint import main as pmain
    enc = _roberta()
    src = str(tmp_path / "pytorch_model.bin")
    torch.save(_hf_state(enc, "roberta."), src)
    flags = ["--layers", "2", "--prefix", "roberta."]
    jmain(["roberta", src, str(tmp_path / "jax"), *flags])
    ppath = pmain(["roberta", src, str(tmp_path / "port"), *flags])
    jparams = jload(str(tmp_path / "jax" / "checkpoints" /
                        "ckpt_epoch_0"))["params"]
    want = _via_jax(jparams, RobertaEncoder(enc.config))
    _assert_same(load_checkpoint(ppath)["params"], want)


# ----------------------------------------------------------------- SwinV1

def test_bias_table_resample_matches_jax():
    from mvuld_tpu.models.swin_convert import interpolate_bias_table as J
    from mvuld_tpu_torch.models.swin_convert import interpolate_bias_table
    rng = np.random.RandomState(0)
    for src, dst, heads in ((7, 12, 4), (12, 7, 3), (6, 8, 1)):
        t = rng.randn((2 * src - 1) ** 2, heads).astype(np.float32)
        got = interpolate_bias_table(torch.as_tensor(t), src, dst)
        assert got.shape == ((2 * dst - 1) ** 2, heads)
        np.testing.assert_allclose(got.numpy(), J(t, src, dst),
                                   **RESAMPLE_TOL)


def _v1(img, window, classes):
    from mvuld_tpu_torch.models.swin_v1 import SwinTransformerV1, SwinV1Config
    return SwinTransformerV1(SwinV1Config(
        img_size=img, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
        window_size=window, num_classes=classes))


@pytest.mark.parametrize("classes", [21841, 5], ids=["22k_to_1k", "reinit"])
def test_convert_swinv1_matches_jax(classes, tmp_path):
    """A window-7 SwinV1 (56², 21841 or 5 classes) into a window-12 one
    (96², 1000 or 2 classes)."""
    from mvuld_tpu.models.swin_convert import swinv1_torch_to_flax
    from mvuld_tpu.models.swin_v1 import SwinV1Config as JCfg
    from mvuld_tpu_torch.models.swin_convert import (convert_swinv1_state_dict,
                                                     load_pretrained_swinv1)
    src = _v1(56, 7, classes)
    init_jax_like(src, torch.Generator().manual_seed(4))
    sd = dict(src.state_dict())
    sd.update(dict(src.named_buffers()))
    dst_classes = 1000 if classes == 21841 else 2
    got = convert_swinv1_state_dict(sd, _v1(96, 12, dst_classes))
    tree = swinv1_torch_to_flax(
        {k: v.numpy() for k, v in sd.items()},
        JCfg(img_size=96, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
             window_size=12, num_classes=dst_classes))
    want = _via_jax(tree, _v1(96, 12, dst_classes))
    tables = [k for k in want if k.endswith("relative_position_bias_table")]
    assert len(tables) == 4 and got[tables[0]].shape == (23 ** 2, 2)
    _assert_same({k: v for k, v in got.items() if k in tables},
                 {k: v for k, v in want.items() if k in tables},
                 **RESAMPLE_TOL)
    _assert_same({k: v for k, v in got.items() if k not in tables},
                 {k: v for k, v in want.items() if k not in tables})
    path = str(tmp_path / "v1.pth")
    torch.save({"model": sd}, path)
    model = _v1(96, 12, dst_classes)
    load_pretrained_swinv1(model, path)
    _assert_same(model.state_dict(), got)
