"""Reference torch fusion-model weights → the port's MultiDefectAblation.

Counterpart of ``mvuld_tpu/models/fusion_convert.py`` (``fusion_torch_to_
flax``). The reference's fusion checkpoints (``mymodel.pth`` /
``pytorch_model.bin``, saved by mvuld/main_bigvul.py:250-260) hold the
state dict of one of the Multi_DefectModel_* classes (mvuld/models/
GraphModel.py, new_model.py, myModels.py, MotivationModel.py);
``fusion_torch_to_port`` maps it onto a ``MultiDefectAblation`` of any key
of the zoo, driven by the flags the registry set on the model.

The port's fusion head keeps the reference's torch leaf layouts, so most
tensors copy over under a new name (``swinbn`` → ``img_proj.bn``,
``Rs_GCN_{i+1}.W.0`` → ``graph.rs_gcn_{i}.W.0`` …): Linear, Conv1d and
BatchNorm1d (running statistics included) as they are, dgl GATConv's
``fc.weight`` [H·D, in], ``attn_l``/``attn_r`` [1, H, D] and ``bias``
[H·D] (zeros when the checkpoint has none) as well. The GRU needs real
mapping: torch ``nn.GRU``'s ``weight_ih_l0`` / ``weight_hh_l0`` [3H, ·]
split by gate (r, z, n) into the flax-style cell's ``ir``, ``iz``, ``in``,
``hr``, ``hz``, ``hn``; ``b_ir + b_hr`` and ``b_iz + b_hz`` fold into the
input biases (``hr``/``hz`` have none), ``b_hn`` stays on ``hn`` (both
compute n = tanh(W_in x + b_in + r·(W_hn h + b_hn))).

It raises on a checkpoint tensor left unused (``num_batches_tracked``
aside) and on a model tensor left unset.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# kinds of leaf module: their reference tensors → port tensors
_LINEAR, _CONV, _BN, _GAT, _GRU = "linear", "conv", "bn", "gat", "gru"


def reference_modules(model) -> List[Tuple[str, str, str]]:
    """(port module path, reference module path, kind) for every leaf
    module of ``model`` (a ``MultiDefectAblation``), in the JAX converter's
    order."""
    out: List[Tuple[str, str, str]] = []
    if model.use_image and model.project_modalities:
        out += [("img_proj.bn", "swinbn", _BN), ("img_proj.fc", "swinfc",
                                                  _LINEAR)]
    if model.use_text and model.project_modalities:
        out += [("text_proj.bn", "bn_text", _BN), ("text_proj.fc", "fc_text",
                                                   _LINEAR)]
    if model.use_graph:
        g = model.graph
        G = "graph."
        if g.pos_mode == "pre_gat":
            out += [(G + "fc_gat_pre", "fc_gat", _LINEAR),
                    (G + "fc_bbox_pre", "fc_bbox", _LINEAR)]
        if g.node_net == "gat":
            out += [(G + "gats.gat", "gat", _GAT),
                    (G + "gats.gat2", "gat2", _GAT),
                    (G + "gats.fc", "fc", _LINEAR)]
        elif g.node_net == "mlp":
            out.append((G + "fconly", "fconly", _LINEAR))
        if g.pos_mode == "pre_hidden":
            out.append((G + "fc_bbox_pre", "fc_bbox", _LINEAR))
        if g.pos_mode == "deep":
            out.append((G + "fc_bbox", "fc_bbox", _LINEAR))
            out += [(G + f"pos_hidden_{i}", f"pos_hidden.{i}", _LINEAR)
                    for i in range(g.num_hidden)]
        if g.num_hidden > 0 and g.node_net != "none":
            out += [(G + f"hidden.fc_{i}", f"hidden.{i}", _LINEAR)
                    for i in range(g.num_hidden)]
        if g.readout == "mean_valid":
            out += [(G + "hbn", "hbn", _BN), (G + "hfc", "hfc", _LINEAR)]
        else:
            if g.post_proj in ("split", "full"):
                out += [(G + "bn_gat", "bn_gat", _BN),
                        (G + "fc_gat", "fc_gat", _LINEAR)]
                if g.post_proj == "split":
                    key = "fc_bbox2" if g.pos_mode == "deep" else "fc_bbox"
                    out += [(G + "bn_bbox", "bn_bbox", _BN),
                            (G + key, key, _LINEAR)]
            elif g.post_proj == "bn_only":
                out.append((G + "bn_gat", "bn_gat", _BN))
            elif g.post_proj == "hfc":
                out += [(G + "bn_gat", "bn_gat", _BN),
                        (G + "hfc", "hfc", _LINEAR)]
            if g.use_rsgcn:
                for i in range(g.num_rs_gcn):
                    p, t = G + f"rs_gcn_{i}.", f"Rs_GCN_{i + 1}."
                    out += [(p + m, t + m, _CONV)
                            for m in ("g", "theta", "phi", "W.0")]
                    out.append((p + "W.1", t + "W.1", _BN))
            if g.readout in ("mean_padded_hfc", "gru"):
                out += [(G + "hbn", "hbn", _BN), (G + "hfc", "hfc", _LINEAR)]
            if g.readout == "gru":
                out.append((G + "gru", "gru_local", _GRU))
    if model.final_bn is not None:
        out.append(("final_bn", "final_bn", _BN))
    out.append(("final_fc", "final_fc", _LINEAR))
    return out


def _gru(sd, prefix: str, hidden: int) -> Dict[str, torch.Tensor]:
    H = hidden
    w_ih, w_hh = sd[f"{prefix}.weight_ih_l0"], sd[f"{prefix}.weight_hh_l0"]
    b_ih, b_hh = sd[f"{prefix}.bias_ih_l0"], sd[f"{prefix}.bias_hh_l0"]
    gate = {g: slice(i * H, (i + 1) * H) for i, g in enumerate("rzn")}
    out = {}
    for g, sl in gate.items():
        out[f"i{g}.weight"] = w_ih[sl]
        out[f"h{g}.weight"] = w_hh[sl]
    out["ir.bias"] = b_ih[gate["r"]] + b_hh[gate["r"]]
    out["iz.bias"] = b_ih[gate["z"]] + b_hh[gate["z"]]
    out["in.bias"] = b_ih[gate["n"]]
    out["hn.bias"] = b_hh[gate["n"]]
    return out


def _leaves(sd, ref: str, kind: str, target: Mapping, port: str
            ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The port tensors of one leaf module (keys relative to it) and the
    reference keys they read."""
    if kind == _GRU:
        hidden = target[f"{port}.hr.weight"].shape[0]
        read = [f"{ref}.{w}_{h}_l0" for w in ("weight", "bias")
                for h in ("ih", "hh")]
        return _gru(sd, ref, hidden), read
    names = {_LINEAR: ("weight", "bias"), _CONV: ("weight", "bias"),
             _BN: ("weight", "bias", "running_mean", "running_var"),
             _GAT: ("fc.weight", "attn_l", "attn_r")}[kind]
    out = {n: sd[f"{ref}.{n}"] for n in names}
    read = [f"{ref}.{n}" for n in names]
    if kind == _GAT:
        bias = sd.get(f"{ref}.bias")
        out["bias"] = (torch.zeros_like(target[f"{port}.bias"])
                       if bias is None else bias)
        read.append(f"{ref}.bias")
    if kind == _BN:
        n = sd.get(f"{ref}.num_batches_tracked")
        out["num_batches_tracked"] = (
            torch.zeros_like(target[f"{port}.num_batches_tracked"])
            if n is None else n)
    return out, read


def fusion_torch_to_port(state_dict: Mapping[str, object], model
                         ) -> Dict[str, torch.Tensor]:
    """The state dict ``model`` (a ``MultiDefectAblation``) loads from a
    reference fusion ``state_dict``. Raises on a checkpoint tensor left
    unused, a model tensor left unset or a shape that does not fit."""
    sd = {k: (v.detach().cpu().float() if isinstance(v, torch.Tensor)
              else torch.as_tensor(np.asarray(v, np.float32)))
          for k, v in state_dict.items()}
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for port, ref, kind in reference_modules(model):
        if ref == "final_bn" and "final_fc_bn.weight" in sd:
            ref = "final_fc_bn"          # the classes that name it so
        try:
            leaves, read = _leaves(sd, ref, kind, target, port)
        except KeyError as e:
            raise KeyError(f"checkpoint has no {e} (for {port!r})") from None
        used.update(read)
        for name, t in leaves.items():
            out[f"{port}.{name}"] = t
    unused = sorted(k for k in sd if k not in used
                    and not k.endswith("num_batches_tracked"))
    if unused:
        raise KeyError(f"checkpoint tensors left unused: {unused[:8]}"
                       f"{' …' if len(unused) > 8 else ''}")
    unset = sorted(set(target) - set(out))
    if unset:
        raise KeyError(f"model tensors left unset: {unset[:8]}"
                       f"{' …' if len(unset) > 8 else ''}")
    for key, t in out.items():
        if tuple(t.shape) != tuple(target[key].shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"model {tuple(target[key].shape)}")
    return {k: out[k].to(target[k].dtype) for k in target}
