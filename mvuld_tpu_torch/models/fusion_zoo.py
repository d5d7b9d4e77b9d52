"""Tri-modal fusion head in PyTorch: the production ``multi_defect_new_gcn``.

Counterpart of ``mvuld_tpu/models/fusion_zoo.py`` at the registry key the
end-to-end model uses (Multi_DefectModel_new_GCN, reference
mvuld/models/GraphModel.py:81-211), in eval mode:

  image 1024 → BN → FC → 512 ─┐
  text   768 → BN → FC → 512 ─┼─ concat 1536 → BN → FC → 2 logits
  graph: node 768 → GAT(512×4h) ×2 → FC 2048→512 → 8×FC(512)
         → BN(node-axis) → FC 512→480 ⊕ bbox 4→32 → 512
         → 8× Rs-GCN → l2norm(nodes) → mean(padded nodes) ──┘

Module paths follow the JAX tree (``img_proj``, ``graph.gats.gat``,
``graph.rs_gcn_{i}``, ``final_bn`` …); the leaf modules carry the
reference's torch layouts (dgl GATConv, Rs_GCN Conv1d + BatchNorm1d,
BatchNorm1d running statistics). The head runs in fp32, as in JAX. The
other registry keys of the zoo belong to a later slice. ``train`` takes
BatchNorm statistics from the batch (flax semantics, ``batch_norm``) and
draws the 0.2 feature dropout of the GATs, the GAT stack and the hidden
stack from ``gen``. Torch BatchNorm1d
needs its feature count up front, so the node-axis BNs take ``max_nodes``
and the bbox projection ``pos_dim`` (JAX infers both from the input).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvuld_tpu_torch.models.dropout import dropout
from mvuld_tpu_torch.models.graph_nets import (DenseGATConv, RsGCN,
                                               batch_norm, l2norm_nodes,
                                               mean_over_max_nodes)

BN_EPS = 1e-5   # flax nn.BatchNorm's default epsilon


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
    """8 shared FC(512→512)+ELU layers (reference: fch/hidden,
    GraphModel.py:113-117, applied at 175-177)."""

    def __init__(self, hidden: int = 512, depth: int = 8, drop: float = 0.2):
        super().__init__()
        self.depth, self.drop = depth, drop
        for i in range(depth):
            self.add_module(f"fc_{i}", nn.Linear(hidden, hidden))

    def forward(self, h, gen=None):
        for i in range(self.depth):
            h = dropout(F.elu(getattr(self, f"fc_{i}")(h)), self.drop, gen)
        return h


class GraphBranch(nn.Module):
    """The graph tower of ``multi_defect_new_gcn``: GAT stack + hidden
    stack, node-axis BN with the split post-projection (node 480 ⊕ bbox 32),
    Rs-GCN blocks, l2norm over nodes and the padded mean."""

    def __init__(self, d_in: int, max_nodes: int, pos_dim: int = 4,
                 hidden: int = 512, heads: int = 4, num_hidden: int = 8,
                 num_rs_gcn: int = 8):
        super().__init__()
        if hidden <= 32:
            raise ValueError(
                "the split post-projection reserves 32 dims for the bbox "
                f"projection (fc_bbox →32); hidden={hidden} must be > 32")
        self.num_hidden, self.num_rs_gcn = num_hidden, num_rs_gcn
        self.gats = GATStack(d_in, hidden, heads)
        self.hidden = HiddenStack(hidden, num_hidden) if num_hidden > 0 else None
        # torch BatchNorm1d(max_node) on [B, N, C]: statistics per NODE
        # POSITION (GraphModel.py:142-145, 186-189)
        self.bn_gat = _bn(max_nodes)
        self.fc_gat = nn.Linear(hidden, hidden - 32)
        self.bn_bbox = _bn(max_nodes)
        self.fc_bbox = nn.Linear(pos_dim, 32)
        for i in range(num_rs_gcn):
            self.add_module(f"rs_gcn_{i}", RsGCN(hidden, hidden))

    def forward(self, node_emb, pos, adj, node_mask, train: bool = False,
                gen=None):
        h = self.gats(node_emb, adj, gen)
        if self.hidden is not None:
            h = self.hidden(h, gen)
        # zero padded nodes: the reference pads AFTER the per-node nets
        h = h * node_mask[..., None]
        h_i = F.elu(self.fc_gat(batch_norm(h, self.bn_gat, train)))
        pos_i = F.elu(self.fc_bbox(batch_norm(pos, self.bn_bbox, train)))
        h = torch.cat([h_i, pos_i], dim=-1)
        for i in range(self.num_rs_gcn):
            h, _aff = getattr(self, f"rs_gcn_{i}")(h, train)
        return mean_over_max_nodes(l2norm_nodes(h))


class MultiDefectAblation(nn.Module):
    """The tri-modal classifier at the ``multi_defect_new_gcn`` defaults:
    image and text projections, the graph branch, concat in the reference
    order (image, GRAPH, text — GraphModel.py:207), BN and the final FC."""

    def __init__(self, num_classes: int = 2, hidden: int = 512,
                 img_dim: int = 1024, text_dim: int = 768,
                 num_rs_gcn: int = 8, num_hidden: int = 8,
                 max_nodes: int = 100, pos_dim: int = 4):
        super().__init__()
        self.img_proj = ProjectBNFC(img_dim, hidden)
        self.graph = GraphBranch(text_dim, max_nodes, pos_dim, hidden,
                                 num_hidden=num_hidden, num_rs_gcn=num_rs_gcn)
        self.text_proj = ProjectBNFC(text_dim, hidden)
        self.final_bn = _bn(3 * hidden)
        self.final_fc = nn.Linear(3 * hidden, num_classes)

    def forward(self, img_emb, text_emb, node_emb, pos, adj, node_mask,
                train: bool = False, gen=None):
        """``gen``: dropout generator, read only when ``train``."""
        gen = gen if train else None
        feats = [self.img_proj(img_emb.float(), train),
                 self.graph(node_emb.float(), pos.float(), adj,
                            node_mask.float(), train, gen),
                 self.text_proj(text_emb.float(), train)]
        fused = batch_norm(torch.cat(feats, dim=-1), self.final_bn, train)
        return self.final_fc(fused).float()
