"""Tri-modal fusion model zoo in PyTorch: the production
``multi_defect_new_gcn`` and its ablations.

Counterpart of ``mvuld_tpu/models/fusion_zoo.py``. The production model
(Multi_DefectModel_new_GCN, reference mvuld/models/GraphModel.py:81-211):

  image 1024 → BN → FC → 512 ─┐
  text   768 → BN → FC → 512 ─┼─ concat 1536 → BN → FC → 2 logits
  graph: node 768 → GAT(512×4h) ×2 → FC 2048→512 → 8×FC(512)
         → BN(node-axis) → FC 512→480 ⊕ bbox 4→32 → 512
         → 8× Rs-GCN → l2norm(nodes) → mean(padded nodes) ──┘

The reference's ablation classes (GraphModel.py, new_model.py,
MotivationModel.py, myModels.py) share this skeleton with components
toggled: here they are ONE parameterized module (``MultiDefectAblation``)
registered under the JAX package's 23 keys in ``FUSION_MODELS`` and built
by ``build_fusion_model`` from MODEL.MULTI.ARCH.

Module paths follow the JAX tree (``img_proj``, ``graph.gats.gat``,
``graph.rs_gcn_{i}``, ``graph.gru.ir``, ``final_bn`` …); the leaf modules
carry the reference's torch layouts (dgl GATConv, Rs_GCN Conv1d +
BatchNorm1d, BatchNorm1d running statistics). The head runs in fp32, as in
JAX. ``train`` takes BatchNorm statistics from the batch (flax semantics,
``batch_norm``) and draws the key's dropout from ``gen``. Torch needs
every width up front where flax infers it from the input: the modules
reckon them from the flags, the node-axis BNs take ``max_nodes`` and the
bbox projections ``pos_dim``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mvuld_tpu_torch.core.registry import FUSION_MODELS
from mvuld_tpu_torch.models.dropout import dropout
from mvuld_tpu_torch.models.graph_nets import (DenseGATConv, GRUCell, RsGCN,
                                               batch_norm, l2norm_nodes,
                                               mean_nodes,
                                               mean_over_max_nodes)

BN_EPS = 1e-5   # flax nn.BatchNorm's default epsilon
NUM_NTYPES = 32  # _ALL_NODE_EMB's node-type one-hot width


def _bn(features: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(features, eps=BN_EPS)


class ProjectBNFC(nn.Module):
    """BatchNorm → Dense → ELU projection used for every modality
    (reference: swinbn/swinfc, bn_text/fc_text, GraphModel.py:150-159)."""

    def __init__(self, d_in: int, out: int):
        super().__init__()
        self.bn = _bn(d_in)
        self.fc = nn.Linear(d_in, out)

    def forward(self, x, train: bool = False):
        return F.elu(self.fc(batch_norm(x, self.bn, train)))


class GATStack(nn.Module):
    """Two stacked 4-head GATs + FC, flattening heads between layers
    (reference: GraphModel.py:167-172)."""

    def __init__(self, d_in: int, hidden: int = 512, heads: int = 4,
                 drop: float = 0.2):
        super().__init__()
        self.hidden, self.heads, self.drop = hidden, heads, drop
        self.gat = DenseGATConv(d_in, hidden, heads, feat_drop=drop)
        self.gat2 = DenseGATConv(hidden * heads, hidden, heads, feat_drop=drop)
        self.fc = nn.Linear(hidden * heads, hidden)

    def forward(self, h, adj, gen=None):
        B, N, _ = h.shape
        h = self.gat(h, adj, gen).reshape(B, N, self.heads * self.hidden)
        h = self.gat2(h, adj, gen).reshape(B, N, self.heads * self.hidden)
        return dropout(F.elu(self.fc(h)), self.drop, gen)


class HiddenStack(nn.Module):
    """8 shared FC(512→512)+ELU+dropout layers (reference: fch/hidden,
    GraphModel.py:113-117, applied at 175-177)."""

    def __init__(self, d_in: int, hidden: int = 512, depth: int = 8,
                 drop: float = 0.2):
        super().__init__()
        self.depth, self.drop = depth, drop
        for i in range(depth):
            self.add_module(f"fc_{i}", nn.Linear(hidden if i else d_in,
                                                 hidden))

    def forward(self, h, gen=None):
        for i in range(self.depth):
            h = dropout(F.elu(getattr(self, f"fc_{i}")(h)), self.drop, gen)
        return h


class GraphBranch(nn.Module):
    """The graph-modality tower, parameterized as the JAX ``GraphBranch``
    (which names the reference variant of each value):

    ``node_net``   gat | mlp | none — per-node network before padding
    ``node_input`` node | all — node emb, or ⊕ 32-d node-type one-hot
    ``pos_mode``   none | post | pre_gat | pre_hidden | deep — where the
                   bbox features enter
    ``post_proj``  split | full | bn_only | hfc | none — the padded
                   [B, N, ·] projection before Rs-GCN / readout
    ``readout``    mean_padded | mean_valid | mean_padded_hfc | gru

    ``d_in`` is the node feature width; ``out_dim`` the width it returns.
    """

    def __init__(self, d_in: int, max_nodes: int, pos_dim: int = 4,
                 hidden: int = 512, heads: int = 4, node_net: str = "gat",
                 node_input: str = "node", num_hidden: int = 8,
                 pos_mode: str = "post", post_proj: str = "split",
                 use_rsgcn: bool = True, num_rs_gcn: int = 8,
                 dropout: float = 0.2, readout: str = "mean_padded"):
        super().__init__()
        self.width, self.node_net, self.node_input = hidden, node_net, node_input
        self.pos_mode, self.post_proj, self.readout = pos_mode, post_proj, readout
        self.use_rsgcn, self.num_rs_gcn = use_rsgcn, num_rs_gcn
        self.num_hidden, self.drop = num_hidden, dropout
        d = d_in + (NUM_NTYPES if node_input == "all" else 0)
        if pos_mode == "pre_gat":
            # _GATPOS: node emb → D−48 ⊕ bbox → 48 before the GAT
            self.fc_gat_pre = nn.Linear(d, d - 48)
            self.fc_bbox_pre = nn.Linear(pos_dim, 48)
        if node_net == "gat":
            self.gats = GATStack(d, hidden, heads, dropout)
            d = hidden
        elif node_net == "mlp":
            d_out = hidden - 32 if pos_mode == "pre_hidden" else hidden
            self.fconly = nn.Linear(d, d_out)
            d = d_out
        if pos_mode == "pre_hidden":
            # _NOGAT4: fconly 768→480 ⊕ fc_bbox 4→32 → hidden stack on 512
            self.fc_bbox_pre = nn.Linear(pos_dim, 32)
            d += 32
        if pos_mode == "deep":
            # _NOGAT3: bbox 4→128 then its own hidden stack
            self.fc_bbox = nn.Linear(pos_dim, 128)
        if num_hidden > 0 and node_net != "none":
            self.hidden = HiddenStack(d, hidden, num_hidden, dropout)
            d = hidden
            if pos_mode == "deep":
                for i in range(num_hidden):
                    self.add_module(f"pos_hidden_{i}", nn.Linear(128, 128))
        if readout == "mean_valid":
            # returns before the post-projection and the Rs-GCN, as in JAX
            self.hbn, self.hfc = _bn(d), nn.Linear(d, hidden)
            self.out_dim = hidden
            return
        if post_proj == "split":
            if hidden <= 32:
                raise ValueError(
                    "post_proj='split' reserves 32 dims for the bbox "
                    "projection (fc_bbox →32, reference GraphModel.py:"
                    f"186-189); hidden={hidden} must be > 32")
            self.bn_gat = _bn(max_nodes)
            self.fc_gat = nn.Linear(d, hidden - 32)
            self.bn_bbox = _bn(max_nodes)
            if pos_mode == "deep":
                self.fc_bbox2 = nn.Linear(128, 32)
            else:
                self.fc_bbox = nn.Linear(pos_dim, 32)
            d = hidden
        elif post_proj == "full":
            self.bn_gat, self.fc_gat = _bn(max_nodes), nn.Linear(d, hidden)
            d = hidden
        elif post_proj == "bn_only":
            self.bn_gat = _bn(max_nodes)
        elif post_proj == "hfc":
            self.bn_gat, self.hfc = _bn(max_nodes), nn.Linear(d, hidden)
            d = hidden
        if use_rsgcn:
            for i in range(num_rs_gcn):
                self.add_module(f"rs_gcn_{i}", RsGCN(hidden, hidden))
        if readout in ("gru", "mean_padded_hfc") and post_proj == "hfc":
            raise ValueError(f"post_proj='hfc' and readout={readout!r} "
                             "both name a module 'hfc'")
        if readout == "gru":
            self.gru = GRUCell(d, hidden)
            self.hbn, self.hfc = _bn(hidden), nn.Linear(hidden, hidden)
            d = hidden
        elif readout == "mean_padded_hfc":
            self.hbn, self.hfc = _bn(d), nn.Linear(d, hidden)
            d = hidden
        self.out_dim = d

    def _readout_fc(self, x, train):
        return F.elu(self.hfc(batch_norm(x, self.hbn, train)))

    def forward(self, node_emb, pos, adj, node_mask, ntype=None,
                train: bool = False, gen=None):
        def drop(x):
            return dropout(x, self.drop, gen)

        h = node_emb
        if self.node_input == "all":
            # _ALL_NODE_EMB: per-line embedding ⊕ 32-d node-type one-hot;
            # an id outside [0, 32) gives a zero row, as jax.nn.one_hot
            ids = torch.arange(NUM_NTYPES, device=ntype.device)
            h = torch.cat([h, (ntype[..., None] == ids).to(h.dtype)], dim=-1)

        if self.pos_mode == "pre_gat":
            h = torch.cat([F.elu(self.fc_gat_pre(h)),
                           F.elu(self.fc_bbox_pre(pos))], dim=-1)

        if self.node_net == "gat":
            h = self.gats(h, adj, gen)
        elif self.node_net == "mlp":
            h = drop(F.elu(self.fconly(h)))

        if self.pos_mode == "pre_hidden":
            h = torch.cat([h, F.elu(self.fc_bbox_pre(pos))], dim=-1)

        deep_pos = None
        if self.pos_mode == "deep":
            deep_pos = F.elu(self.fc_bbox(pos))

        if self.num_hidden > 0 and self.node_net != "none":
            h = self.hidden(h, gen)
            if deep_pos is not None:
                for i in range(self.num_hidden):
                    deep_pos = drop(F.elu(
                        getattr(self, f"pos_hidden_{i}")(deep_pos)))
        # zero padded nodes: the reference pads AFTER the per-node nets on
        # the true-size graph (GraphModel.py:30-54)
        h = h * node_mask[..., None]
        if deep_pos is not None:
            deep_pos = deep_pos * node_mask[..., None]

        if self.readout == "mean_valid":
            return self._readout_fc(mean_nodes(h, node_mask), train)

        if self.post_proj == "split":
            # torch BatchNorm1d(max_node) on [B, N, C]: statistics per NODE
            # POSITION (GraphModel.py:142-145, 186-189)
            h_i = F.elu(self.fc_gat(batch_norm(h, self.bn_gat, train)))
            pos_src = deep_pos if deep_pos is not None else pos
            fc_pos = self.fc_bbox2 if deep_pos is not None else self.fc_bbox
            pos_i = F.elu(fc_pos(batch_norm(pos_src, self.bn_bbox, train)))
            h = torch.cat([h_i, pos_i], dim=-1)
        elif self.post_proj == "full":
            h = F.elu(self.fc_gat(batch_norm(h, self.bn_gat, train)))
        elif self.post_proj == "bn_only":
            h = F.elu(batch_norm(h, self.bn_gat, train))
        elif self.post_proj == "hfc":
            h = F.elu(self.hfc(batch_norm(h, self.bn_gat, train)))

        if self.use_rsgcn:
            for i in range(self.num_rs_gcn):
                h, _aff = getattr(self, f"rs_gcn_{i}")(h, train)
            h = l2norm_nodes(h)

        if self.readout == "gru":
            # GRU over the PADDED node sequence, last state (the zero-pad
            # tail included — quirk kept, myModels.py:250-251)
            state = h.new_zeros((h.shape[0], self.width))
            for t in range(h.shape[1]):
                state = self.gru(state, h[:, t])
            return self._readout_fc(state, train)

        out = mean_over_max_nodes(h)
        if self.readout == "mean_padded_hfc":
            out = self._readout_fc(out, train)
        return out


class MultiDefectAblation(nn.Module):
    """Parameterized tri-modal classifier covering the whole ablation zoo:
    the modality projections, the graph branch (``GraphBranch``'s flags),
    the fusion of the features in the reference order (image, GRAPH, text —
    GraphModel.py:207), the final BN and FC, and dropout on the logits.

    ``fusion``: concat | dot | dot_image_graph | attention_image_graph (the
    last two fall back to concat with fewer than three modalities);
    ``project_modalities=False`` classifies the raw embeddings."""

    def __init__(self, num_classes: int = 2, hidden: int = 512,
                 img_dim: int = 1024, text_dim: int = 768,
                 use_image: bool = True, use_text: bool = True,
                 use_graph: bool = True, node_net: str = "gat",
                 node_input: str = "node", pos_mode: str = "post",
                 post_proj: str = "split", use_rsgcn: bool = True,
                 num_rs_gcn: int = 8, num_hidden: int = 8,
                 dropout: float = 0.2, readout: str = "mean_padded",
                 fusion: str = "concat", final_bn: bool = True,
                 project_modalities: bool = True, final_dropout: float = 0.0,
                 max_nodes: int = 100, pos_dim: int = 4):
        super().__init__()
        self.use_image, self.use_text, self.use_graph = (use_image, use_text,
                                                         use_graph)
        self.project_modalities, self.fusion = project_modalities, fusion
        self.final_dropout = final_dropout
        widths = []
        if use_image:
            if project_modalities:
                self.img_proj = ProjectBNFC(img_dim, hidden)
            widths.append(hidden if project_modalities else img_dim)
        if use_graph:
            self.graph = GraphBranch(
                text_dim, max_nodes, pos_dim, hidden, node_net=node_net,
                node_input=node_input, num_hidden=num_hidden,
                pos_mode=pos_mode, post_proj=post_proj, use_rsgcn=use_rsgcn,
                num_rs_gcn=num_rs_gcn, dropout=dropout, readout=readout)
            widths.append(self.graph.out_dim)
        if use_text:
            if project_modalities:
                self.text_proj = ProjectBNFC(text_dim, hidden)
            widths.append(hidden if project_modalities else text_dim)
        if fusion in ("dot_image_graph", "attention_image_graph") \
                and len(widths) == 3:
            width = widths[1] + widths[2]
        elif fusion == "dot" and len(widths) >= 2:
            width = widths[0]
        else:
            width = sum(widths)
        self.final_bn = _bn(width) if final_bn else None
        self.final_fc = nn.Linear(width, num_classes)

    def forward(self, img_emb=None, text_emb=None, node_emb=None, pos=None,
                adj=None, node_mask=None, ntype=None, train: bool = False,
                gen=None):
        """Inputs a key does not read may be None; float inputs are cast
        to the parameters' type (fp32). ``gen``: dropout generator, read
        only when ``train``."""
        gen = gen if train else None
        dt = self.final_fc.weight.dtype
        feats = []
        if self.use_image:
            x = img_emb.to(dt)
            feats.append(self.img_proj(x, train) if self.project_modalities
                         else x)
        if self.use_graph:
            feats.append(self.graph(node_emb.to(dt), pos.to(dt), adj,
                                    node_mask.to(dt), ntype, train, gen))
        if self.use_text:
            x = text_emb.to(dt)
            feats.append(self.text_proj(x, train) if self.project_modalities
                         else x)
        if self.fusion == "dot_image_graph" and len(feats) == 3:
            # _grudot: image*graph element-wise, then concat text
            # (myModels.py:254-255)
            fused = torch.cat([feats[0] * feats[1], feats[2]], dim=-1)
        elif self.fusion == "attention_image_graph" and len(feats) == 3:
            # softmax(tanh(img*graph)) gates the graph feature, concat text
            # (myModels.py:407-416)
            a = torch.softmax(torch.tanh(feats[0] * feats[1]), dim=1)
            fused = torch.cat([a * feats[1], feats[2]], dim=-1)
        elif self.fusion == "dot" and len(feats) >= 2:
            # text*graph product (new_model.py:198)
            fused = feats[0]
            for f in feats[1:]:
                fused = fused * f
        else:
            fused = torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]
        if self.final_bn is not None:
            fused = batch_norm(fused, self.final_bn, train)
        logits = self.final_fc(fused)
        return dropout(logits, self.final_dropout, gen)


def _make(key: str, **flags):
    @FUSION_MODELS.register(key)
    def _build(cfg=None, **overrides):
        kw = dict(flags)
        if cfg is not None:
            # a key's own flag (num_hidden=0) wins over the config
            m = cfg.MODEL.MULTI
            for k, v in (("hidden", m.HIDDEN), ("img_dim", m.IMG_DIM),
                         ("text_dim", m.TEXT_DIM),
                         ("num_rs_gcn", m.NUM_RS_GCN),
                         ("num_hidden", m.NUM_HIDDEN_FC),
                         ("max_nodes", cfg.DATA.MAX_NODES),
                         ("pos_dim", 4 + 2 * int(cfg.DATA.NODE_NUMERIC))):
                kw.setdefault(k, v)
            kw["num_classes"] = cfg.MODEL.NUM_CLASSES
        kw.update(overrides)
        return MultiDefectAblation(**kw)
    _build.__name__ = f"build_{key}"
    return _build


# The keys and flag sets of the JAX registry (mvuld_tpu/models/
# fusion_zoo.py), which names the reference class of each.
# ---- GraphModel.py ----------------------------------------------------
_make("multi_defect_new_gcn")
_make("multi_defect", pos_mode="none", post_proj="none", use_rsgcn=False,
      readout="mean_valid", dropout=0.1)
_make("multi_defect_nograph", use_graph=False)
_make("multi_defect_000", node_net="mlp", num_hidden=0, pos_mode="none",
      post_proj="none", use_rsgcn=False, readout="mean_valid")
_make("multi_defect_001", node_net="mlp", num_hidden=0, pos_mode="none",
      post_proj="full", use_rsgcn=True)
_make("multi_defect_100", node_net="mlp", num_hidden=0, pos_mode="post",
      post_proj="split", use_rsgcn=False)
_make("multi_defect_110", pos_mode="post", post_proj="split",
      use_rsgcn=False, dropout=0.1)
_make("multi_defect_gatpos", pos_mode="pre_gat", post_proj="hfc",
      use_rsgcn=False, dropout=0.1)
_make("multi_defect_011", pos_mode="none", post_proj="bn_only",
      use_rsgcn=True)
_make("multi_defect_nogat", node_net="none", num_hidden=0, pos_mode="post",
      post_proj="split", use_rsgcn=True)
_make("multi_defect_nogat2", node_net="mlp", pos_mode="post",
      post_proj="split", use_rsgcn=True)
_make("multi_defect_nogat3", node_net="mlp", pos_mode="deep",
      post_proj="split", use_rsgcn=True)
_make("multi_defect_nogat4", node_net="mlp", pos_mode="pre_hidden",
      post_proj="full", use_rsgcn=True)
# ---- new_model.py -------------------------------------------------------
_make("multi_defect_noglobalimage", use_image=False, fusion="dot")
_make("multi_defect_nofunc", use_text=False)
# ---- myModels.py --------------------------------------------------------
_make("multi_defect_allnode", node_input="all", pos_mode="none",
      post_proj="none", use_rsgcn=False, readout="mean_padded_hfc")
_make("multi_defect_grudot", pos_mode="none", post_proj="none",
      use_rsgcn=False, readout="gru", fusion="dot_image_graph",
      final_dropout=0.3)
_make("multi_defect_gruproj", pos_mode="none", post_proj="none",
      use_rsgcn=False, readout="gru", fusion="attention_image_graph")
# ---- MotivationModel.py -------------------------------------------------
_make("motivation_image", use_text=False, use_graph=False,
      project_modalities=False, final_bn=False)
_make("motivation_functext", use_image=False, use_graph=False,
      project_modalities=False, final_bn=False)
_make("motivation_graph", use_image=False, use_text=False, final_bn=False)
_make("motivation_graph1", use_image=False, use_text=False, node_net="mlp",
      pos_mode="none", post_proj="full", use_rsgcn=True, final_bn=False)
_make("motivation_graph_mean", use_image=False, use_text=False,
      pos_mode="none", post_proj="none", use_rsgcn=False,
      readout="mean_valid", dropout=0.1, final_bn=False)


def build_fusion_model(cfg, arch: Optional[str] = None,
                       **overrides) -> MultiDefectAblation:
    """The fusion architecture selected by ``arch`` or MODEL.MULTI.ARCH,
    sized from MODEL.MULTI, MODEL.NUM_CLASSES, DATA.MAX_NODES and
    DATA.NODE_NUMERIC. An unknown key raises the registry's KeyError."""
    return FUSION_MODELS.build(arch or cfg.MODEL.MULTI.ARCH, cfg, **overrides)
