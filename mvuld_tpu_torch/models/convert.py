"""JAX variables → the port's modules, and JAX-like random initialisation.

A JAX run's variables travel as one ``.npz`` whose keys are the flattened
variable paths joined by ``/`` (``params/swin/patch_embed/proj/kernel``,
``batch_stats/fusion/img_proj/bn/mean`` …); ``flatten_variables`` builds
that dict from any nested mapping of arrays, so exporting takes
``np.savez(path, **flatten_variables(variables))`` in the JAX environment.
``jax_variables_to_torch`` loads it into an ``EndToEndMVulD`` or into one of
its towers (``SwinTransformerV2``, ``RobertaEncoder``,
``MultiDefectAblation`` under any key of the fusion zoo), into a
``UniXcoderClassifier`` / ``UniXcoderEmbedder`` (``encoder/…`` and
``classifier``), into an operator of ``BILINEAR_FUSIONS`` (Dense leaves
and the raw Tucker cores), or into the EAST detector (``ocr/east.py``,
Flax module names: ``extractor/conv_{i}``, ``merge/bn_{i}``,
``score_head`` …), or into a baseline detector (``models/baselines.py``:
Devign, GGNNSum, the metric learner, IVDetect and their GGNN, masked GRU
and TreeLSTM parts), or into a model of the Swin family
(``SwinTransformerV1``, ``SwinTransformerMoE``, ``SwinMLP``: the V1 bias
``relative_position_bias_table``, the Swin-MLP ``spatial_mlp`` and the
MoE's ``gate``, ``w1``, ``b1``, ``w2``, ``b2`` keep name and layout, the
bias-free ``downsample.reduction`` is a Dense kernel), with the layout
rules:

  Dense ``kernel`` [in, out]       → ``weight`` [out, in]
  Conv ``kernel`` HWIO             → ``weight`` OIHW
  LayerNorm / BatchNorm ``scale``  → ``weight``
  BatchNorm ``mean`` / ``var``     → ``running_mean`` / ``running_var``
  Embed ``embedding``              → ``weight``
  Conv ``kernel`` [k, Cin, Cout]   → ``Conv1d.weight`` [Cout, Cin, k]
  SwinV2 ``layers_{i}_scan/block{b}`` leaves [pairs, …] → blocks 2p + b

and the module names of the reference torch models where the JAX
converters name them (``attn.cpb_mlp.0``, ``encoder.layer.{i}.attention.
self.query``, dgl GATConv's ``attn_l`` [1, H, D], Rs_GCN's ``W.0``/``W.1``).
flax ``GRUCell``'s six dense leaves (``gru/ir`` … ``gru/hn``) keep their
names, one ``Linear`` each; the cell of a flax ``nn.RNN`` (``GRUCell_0``)
is the baselines' ``MaskedGRU.cell``; raw parameters (``etype_w``, the
TreeLSTM's ``W_iou`` …) keep name and layout.
``baseline_params_tree`` writes a baseline's parameters back as the flax
``params`` tree, each kernel through the inverse of the same layout rule
(``_KERNEL_AXES``).
It raises on a key it leaves unused and on a port tensor it leaves unset.
``torch_to_jax_names`` is the inverse name map: each port parameter and
BatchNorm statistic to its JAX variable path, as the decay mask and the
gradient comparisons need it.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

Mapped = Iterator[Tuple[str, np.ndarray]]


def flatten_variables(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping of arrays → {"a/b/c": np.ndarray}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_variables(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


_LEAF = {"scale": "weight", "embedding": "weight", "mean": "running_mean",
         "var": "running_var"}
# a flax kernel's axes in the torch weight's order, by rank: Dense [in, out]
# → [out, in], Conv [k, Cin, Cout] → [Cout, Cin, k], Conv HWIO → OIHW
_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def _leaf(path: List[str], arr: np.ndarray) -> Mapped:
    """Generic rule: join the path with '.', torch leaf name and layout."""
    *mods, name = path
    if name == "kernel":
        arr = arr.transpose(_KERNEL_AXES[arr.ndim])
        name = "weight"
    yield ".".join(mods + [_LEAF.get(name, name)]), arr


def _prefixed(prefix: str, items: Mapped) -> Mapped:
    for k, v in items:
        yield prefix + k, v


# ------------------------------------------------------------------ swin

def _swin_block(path: List[str], arr: np.ndarray) -> Mapped:
    if path == ["attn", "qkv_kernel"]:
        yield "attn.qkv.weight", arr.T
    elif path[:2] == ["attn", "cpb_fc1"]:
        yield from _leaf(["attn", "cpb_mlp", "0", path[2]], arr)
    elif path[:2] == ["attn", "cpb_fc2"]:
        yield from _leaf(["attn", "cpb_mlp", "2", path[2]], arr)
    else:
        yield from _leaf(path, arr)


def _swin(path: List[str], arr: np.ndarray) -> Mapped:
    head = path[0]
    m = re.fullmatch(r"layers_(\d+)_blocks_(\d+)", head)
    if m:
        yield from _prefixed(f"layers.{m[1]}.blocks.{m[2]}.",
                             _swin_block(path[1:], arr))
        return
    m = re.fullmatch(r"layers_(\d+)_scan", head)
    if m:
        b = {"block0": 0, "block1": 1}[path[1]]
        for p in range(arr.shape[0]):       # scan layout: leading pair axis
            yield from _prefixed(f"layers.{m[1]}.blocks.{2 * p + b}.",
                                 _swin_block(path[2:], arr[p]))
        return
    m = re.fullmatch(r"layers_(\d+)_downsample", head)
    if m:
        yield from _prefixed(f"layers.{m[1]}.downsample.", _leaf(path[1:], arr))
        return
    yield from _leaf(path, arr)


# ------------------------------------------------------------------ roberta

_ROBERTA_LAYER = {"attention_norm": ["attention", "output", "LayerNorm"],
                  "intermediate": ["intermediate", "dense"],
                  "mlp_output": ["output", "dense"],
                  "output_norm": ["output", "LayerNorm"]}


def _roberta(path: List[str], arr: np.ndarray) -> Mapped:
    head = path[0]
    if head == "embeddings_norm":
        yield from _leaf(["embeddings", "LayerNorm"] + path[1:], arr)
        return
    if head.endswith("_embeddings"):
        yield from _leaf(["embeddings"] + path, arr)
        return
    m = re.fullmatch(r"layer_(\d+)", head)
    if not m:
        raise KeyError(f"unknown RoBERTa variable {'/'.join(path)}")
    sub = path[1]
    if sub == "attention":
        mods = (["attention", "output", "dense"] if path[2] == "output"
                else ["attention", "self", path[2]])
        rest = path[3:]
    else:
        mods, rest = _ROBERTA_LAYER[sub], path[2:]
    yield from _prefixed(f"encoder.layer.{m[1]}.", _leaf(mods + rest, arr))


def _unixcoder(path: List[str], arr: np.ndarray) -> Mapped:
    if path[0] == "encoder":
        yield from _prefixed("encoder.", _roberta(path[1:], arr))
    elif path[0] == "classifier":
        yield from _leaf(path, arr)
    else:
        raise KeyError(f"unknown UniXcoder variable {'/'.join(path)}")


# ------------------------------------------------------------------ fusion

def _fusion(path: List[str], arr: np.ndarray) -> Mapped:
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if parent in ("gat", "gat2") and name in ("attn_l", "attn_r"):
        yield ".".join(path), arr[None]                  # [H, D] → [1, H, D]
        return
    if parent in ("gat", "gat2") and name == "bias":
        yield ".".join(path), arr.reshape(-1)            # [H, D] → [H·D]
        return
    rs = next((i for i, p in enumerate(path) if p.startswith("rs_gcn_")), None)
    if rs is not None:
        mods, sub = path[:rs + 1], path[rs + 1]
        conv = {"g": "g", "theta": "theta", "phi": "phi", "W": "W.0"}
        if sub in conv:                        # 1×1 Conv1d [out, in, 1]
            w = arr.T[:, :, None] if name == "kernel" else arr
            yield ".".join(mods + [conv[sub], "weight" if name == "kernel"
                                   else name]), w
        else:                                  # "bn" → W.1
            yield from _leaf(mods + ["W", "1", name], arr)
        return
    yield from _leaf(path, arr)


# ------------------------------------------------------------------ baselines

def _baseline(path: List[str], arr: np.ndarray) -> Mapped:
    """Devign / ReVeal / IVDetect: the generic rule, with the cell that
    ``nn.RNN`` creates (``GRUCell_0``) as ``cell``; ``etype_w`` and the
    TreeLSTM's raw parameters keep name and layout."""
    yield from _leaf(["cell" if p == "GRUCell_0" else p for p in path], arr)


def _is_baseline(model: nn.Module) -> bool:
    from mvuld_tpu_torch.models import baselines as bl
    from mvuld_tpu_torch.models.graph_nets import DenseGGNN
    return isinstance(model, (bl.DevignModel, bl.GGNNSum,
                              bl.MetricLearningModel, bl.IVDetect,
                              bl.MaskedGRU, bl.ChildSumTreeLSTM, DenseGGNN))


# ------------------------------------------------------------------ dispatch

def _is_bilinear(model: nn.Module) -> bool:
    from mvuld_tpu_torch.models.bilinear_fusion import BILINEAR_FUSIONS
    return isinstance(model, tuple(BILINEAR_FUSIONS.get(k)
                                   for k in BILINEAR_FUSIONS.keys()))


def _is_swin(model: nn.Module) -> bool:
    from mvuld_tpu_torch.models.swin_v1 import SwinBackboneV1
    from mvuld_tpu_torch.models.swin_v2 import SwinTransformerV2
    return isinstance(model, (SwinTransformerV2, SwinBackboneV1))


def _rules(model: nn.Module):
    from mvuld_tpu_torch.models.e2e import EndToEndMVulD
    from mvuld_tpu_torch.models.fusion_zoo import MultiDefectAblation
    from mvuld_tpu_torch.models.roberta import RobertaEncoder
    from mvuld_tpu_torch.models.unixcoder import UniXcoderEmbedder
    from mvuld_tpu_torch.ocr.east import EAST

    if _is_swin(model):
        return _swin
    if isinstance(model, EAST):
        return _leaf
    if isinstance(model, UniXcoderEmbedder):
        return _unixcoder
    if isinstance(model, RobertaEncoder):
        return _roberta
    if isinstance(model, MultiDefectAblation):
        return _fusion
    if _is_bilinear(model):
        return _leaf
    if _is_baseline(model):
        return _baseline
    if isinstance(model, EndToEndMVulD):
        towers = {"swin": _swin, "text_encoder": _roberta, "fusion": _fusion}

        def e2e(path, arr):
            if path[0] not in towers:
                raise KeyError(f"unknown tower {path[0]!r}")
            yield from _prefixed(path[0] + ".", towers[path[0]](path[1:], arr))
        return e2e
    raise TypeError(f"no JAX variable mapping for {type(model).__name__}")


def jax_variables_to_torch(flat: Mapping[str, np.ndarray], model: nn.Module
                           ) -> None:
    """Load flattened JAX variables (``params/…`` and ``batch_stats/…``)
    into ``model`` in place. Raises on an unused key, a shape mismatch, or a
    port tensor left unset."""
    rule = _rules(model)
    target = model.state_dict()
    loaded: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        coll, _, rest = key.partition("/")
        if coll not in ("params", "batch_stats") or not rest:
            raise KeyError(f"unused JAX variable {key!r} (not params/ or "
                           f"batch_stats/)")
        try:
            mapped = list(rule(rest.split("/"), np.asarray(value)))
        except (KeyError, IndexError) as e:
            raise KeyError(f"unused JAX variable {key!r}: {e}") from None
        for port_key, arr in mapped:
            if port_key not in target:
                raise KeyError(f"unused JAX variable {key!r} (maps to "
                               f"{port_key!r}, not in {type(model).__name__})")
            if tuple(arr.shape) != tuple(target[port_key].shape):
                raise ValueError(f"{key!r} → {port_key!r}: shape "
                                 f"{tuple(arr.shape)} != "
                                 f"{tuple(target[port_key].shape)}")
            loaded[port_key] = torch.as_tensor(np.ascontiguousarray(arr))
    for k, v in target.items():
        if k.endswith("num_batches_tracked"):
            loaded.setdefault(k, torch.zeros_like(v))
    unset = sorted(set(target) - set(loaded))
    if unset:
        raise KeyError(f"port tensors left unset by the JAX variables: "
                       f"{unset[:8]}{' …' if len(unset) > 8 else ''}")
    model.load_state_dict(loaded, strict=True)


@torch.no_grad()
def init_jax_like(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from ``generator`` with the JAX package's
    initialisers: dense and conv kernels lecun-normal (truncated at two
    standard deviations), biases 0, LayerNorm and BatchNorm scale 1 and
    shift 0 (Rs-GCN's BN scale 0), running statistics 0 and 1, embeddings
    normal with std 1/√features, GAT attention vectors xavier-normal,
    ``logit_scale`` log 10, the GRU's recurrent kernels orthogonal, the
    Tucker cores normal with std 0.02, and the GGNN's ``etype_w`` and the
    TreeLSTM's raw kernels xavier-uniform."""
    from mvuld_tpu_torch.models.baselines import ChildSumTreeLSTM
    from mvuld_tpu_torch.models.bilinear_fusion import BlockTucker, Tucker
    from mvuld_tpu_torch.models.graph_nets import (DenseGATConv, DenseGGNN,
                                                   GRUCell, RsGCN)
    from mvuld_tpu_torch.models.moe import MoEFFN
    from mvuld_tpu_torch.models.swin_v1 import (SwinBackboneV1,
                                                WindowAttentionV1)
    from mvuld_tpu_torch.models.swin_v2 import WindowAttentionV2
    from mvuld_tpu_torch.models.swin_variants import SwinMLPBlock

    def xavier(w: torch.Tensor):
        # flax xavier_uniform: leading axes are receptive field
        field = math.prod(w.shape[:-2])
        limit = math.sqrt(6.0 / ((w.shape[-2] + w.shape[-1]) * field))
        w.copy_(torch.empty(w.shape).uniform_(-limit, limit,
                                              generator=generator))

    def lecun(w: torch.Tensor, fan_in: int):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        t = nn.init.trunc_normal_(torch.empty(w.shape), 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
        w.copy_(t * std)

    def trunc_normal(w: torch.Tensor, std: float):
        # flax truncated_normal(std): ±2 standard deviations, then scaled
        t = nn.init.trunc_normal_(torch.empty(w.shape), 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
        w.copy_(t * std / 0.87962566103423978)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            lecun(mod.weight, mod.weight[0].numel())
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, _BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, _BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(torch.empty(mod.weight.shape).normal_(
                0.0, 1.0 / math.sqrt(mod.weight.shape[1]), generator=generator))
    for mod in model.modules():
        if isinstance(mod, WindowAttentionV2):
            mod.logit_scale.fill_(math.log(10.0))
            if mod.q_bias is not None:
                mod.q_bias.zero_()
                mod.v_bias.zero_()
        elif isinstance(mod, DenseGATConv):
            H, D = mod.num_heads, mod.out_feats
            std = math.sqrt(2.0 / (H + D))
            for p in (mod.attn_l, mod.attn_r):
                p.copy_(torch.empty(p.shape).normal_(0.0, std,
                                                     generator=generator))
            mod.bias.zero_()
        elif isinstance(mod, RsGCN):
            mod.W[1].weight.zero_()
        elif isinstance(mod, GRUCell):
            for gate in ("hr", "hz", "hn"):
                w = mod._modules[gate].weight
                # flax orthogonal(): q of a normal matrix's QR, signs fixed
                q, r = torch.linalg.qr(torch.empty(w.shape).normal_(
                    generator=generator))
                w.copy_(q * torch.sign(torch.diagonal(r))[None])
        elif isinstance(mod, DenseGGNN):
            xavier(mod.etype_w)
        elif isinstance(mod, ChildSumTreeLSTM):
            for p in (mod.W_iou, mod.U_iou, mod.W_f, mod.U_f):
                xavier(p)
            mod.b_iou.zero_()
            mod.b_f.zero_()
        elif isinstance(mod, WindowAttentionV1):
            trunc_normal(mod.relative_position_bias_table, 0.02)
        elif isinstance(mod, SwinMLPBlock):
            # flax lecun_normal on [H, n, n]: fan_in n · H
            lecun(mod.spatial_mlp, mod.spatial_mlp[0].numel())
        elif isinstance(mod, MoEFFN):
            # fan_in D (gate [D, E]), D · E (w1), Hd · E (w2); biases 0
            lecun(mod.gate, mod.gate.shape[0])
            lecun(mod.w1, mod.w1.shape[0] * mod.w1.shape[1])
            lecun(mod.w2, mod.w2.shape[0] * mod.w2.shape[1])
            mod.b1.zero_()
            mod.b2.zero_()
        elif (isinstance(mod, SwinBackboneV1)
              and mod.absolute_pos_embed is not None):
            trunc_normal(mod.absolute_pos_embed, 0.02)
        elif isinstance(mod, (Tucker, BlockTucker)):
            for name, p in mod.named_parameters(recurse=False):
                if name.startswith("core"):
                    p.copy_(torch.empty(p.shape).normal_(
                        0.0, 0.02, generator=generator))


# ------------------------------------------------------------------ inverse

_INV_SWIN_BLOCK = [(r"attn\.qkv\.kernel$", "attn/qkv_kernel"),
                   (r"attn\.cpb_mlp\.0\.", "attn/cpb_fc1/"),
                   (r"attn\.cpb_mlp\.2\.", "attn/cpb_fc2/")]
_INV_ROBERTA = [(r"^embeddings\.LayerNorm\.", "embeddings_norm/"),
                (r"^embeddings\.", ""),
                (r"\.attention\.self\.", "/attention/"),
                (r"\.attention\.output\.dense\.", "/attention/output/"),
                (r"\.attention\.output\.LayerNorm\.", "/attention_norm/"),
                (r"\.intermediate\.dense\.", "/intermediate/"),
                (r"\.output\.dense\.", "/mlp_output/"),
                (r"\.output\.LayerNorm\.", "/output_norm/"),
                (r"^encoder\.layer\.(\d+)", r"layer_\1")]
_INV_FUSION = [(r"(rs_gcn_\d+)\.W\.0\.", r"\1/W/"),
               (r"(rs_gcn_\d+)\.W\.1\.", r"\1/bn/")]
_INV_BASELINE = [(r"(^|\.)cell\.", r"\1GRUCell_0.")]
_INV_SWIN = [(r"^layers\.(\d+)\.blocks\.(\d+)\.", r"layers_\1_blocks_\2/"),
             (r"^layers\.(\d+)\.downsample\.", r"layers_\1_downsample/")]


def _jax_leaf(mod: nn.Module, leaf: str) -> str:
    if leaf == "weight":
        if isinstance(mod, (nn.LayerNorm, _BatchNorm)):
            return "scale"
        if isinstance(mod, nn.Embedding):
            return "embedding"
        return "kernel"
    return {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)


def _inverse_tower(tower: str, name: str) -> str:
    rules = {"swin": _INV_SWIN_BLOCK + _INV_SWIN, "swin_v1": _INV_SWIN,
             "text_encoder": _INV_ROBERTA,
             "fusion": _INV_FUSION, "baseline": _INV_BASELINE,
             "leaf": []}[tower]
    for pat, rep in rules:
        name = re.sub(pat, rep, name)
    return name.replace(".", "/")


def torch_to_jax_names(model: nn.Module) -> Dict[str, str]:
    """{state_dict key: JAX variable path} for every parameter and
    BatchNorm running statistic of an ``EndToEndMVulD``, e.g.
    ``swin.layers.0.blocks.1.attn.cpb_mlp.0.weight`` →
    ``params/swin/layers_0_blocks_1/attn/cpb_fc1/kernel`` and
    ``fusion.graph.rs_gcn_0.W.1.running_var`` →
    ``batch_stats/fusion/graph/rs_gcn_0/bn/var``, or of a
    ``SwinTransformerV2`` alone (``params/layers_0_blocks_1/…``,
    ``params/head/kernel``), of a ``MultiDefectAblation`` alone
    (``params/graph/rs_gcn_0/W/kernel``), or of a ``UniXcoderClassifier`` /
    ``UniXcoderEmbedder`` (``params/encoder/layer_0/…``,
    ``params/classifier/kernel``), or of a bilinear fusion operator
    (``params/linear0/kernel``, ``params/core_0``). SwinV2 blocks take the
    unscanned ``layers_{i}_blocks_{j}`` names."""
    from mvuld_tpu_torch.models.fusion_zoo import MultiDefectAblation
    from mvuld_tpu_torch.models.swin_v2 import SwinTransformerV2
    from mvuld_tpu_torch.models.unixcoder import UniXcoderEmbedder
    from mvuld_tpu_torch.ocr.east import EAST

    if _is_swin(model):
        towers = [("", model, "swin" if isinstance(model, SwinTransformerV2)
                   else "swin_v1")]
    elif isinstance(model, MultiDefectAblation):
        towers = [("", model, "fusion")]
    elif _is_bilinear(model) or isinstance(model, EAST):
        towers = [("", model, "leaf")]
    elif _is_baseline(model):
        towers = [("", model, "baseline")]
    elif isinstance(model, UniXcoderEmbedder):
        towers = [("encoder", model.encoder, "text_encoder")]
        if hasattr(model, "classifier"):
            towers.append(("classifier", model.classifier, "leaf"))
    else:
        towers = [(t, getattr(model, t), t)
                  for t in ("swin", "text_encoder", "fusion")]
    out: Dict[str, str] = {}
    for prefix, mod, rules in towers:
        modules = dict(mod.named_modules())
        for key in mod.state_dict():
            owner, _, leaf = key.rpartition(".")
            if leaf == "num_batches_tracked":
                continue
            coll = ("batch_stats" if leaf.startswith("running_")
                    else "params")
            jleaf = _jax_leaf(modules[owner], leaf)
            path = _inverse_tower(rules, f"{owner}.{jleaf}" if owner
                                  else jleaf)
            out[f"{prefix}.{key}" if prefix else key] = (
                f"{coll}/{prefix}/{path}" if prefix else f"{coll}/{path}")
    return out


def baseline_params_tree(model: nn.Module) -> Dict:
    """A baseline detector's parameters as the flax ``params`` tree: nested
    dicts of numpy arrays under the JAX names and layouts, as the JAX
    package's ``save_baseline_ckpt`` writes them. ``jax_variables_to_torch(
    flatten_variables({"params": tree}), model)`` loads it back."""
    if not _is_baseline(model):
        raise TypeError(f"{type(model).__name__} is not a baseline detector")
    names = torch_to_jax_names(model)
    tree: Dict = {}
    for key, t in model.state_dict().items():
        a = t.detach().cpu().numpy()
        *path, leaf = names[key].split("/")[1:]
        if leaf == "kernel":                 # the inverse of _leaf's layout
            a = a.transpose(np.argsort(_KERNEL_AXES[a.ndim]))
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree
