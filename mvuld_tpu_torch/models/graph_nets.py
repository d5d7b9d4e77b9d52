"""Dense masked graph layers in PyTorch: GAT, Rs-GCN, GGNN and the
readouts.

Counterpart of ``mvuld_tpu/models/graph_nets.py`` over the same dense
[B, N, ·] layout:

  * ``DenseGATConv`` ≡ dgl.nn.GATConv (LeakyReLU(0.2) additive attention,
    softmax over in-neighbors, per-head out = Σ α · (W h_src), bias); its
    parameters carry dgl's names and shapes (``fc.weight``, ``attn_l``
    [1, H, D], ``attn_r``, ``bias`` [H·D]);
  * ``RsGCN`` ≡ mvuld/models/Rs_GCN.py:7-73 with the reference's module
    names (1×1 ``Conv1d`` g/theta/phi, ``W`` = Conv1d + BatchNorm1d), run
    channels-last;
  * ``GRUCell`` ≡ flax ``nn.GRUCell`` (six dense leaves ``ir`` … ``hn``),
    shared by the fusion zoo's GRU readout and the baselines;
  * ``DenseGGNN`` ≡ dgl GatedGraphConv (per-etype linear messages + GRU),
    the Devign / ReVeal encoder;
  * ``l2norm_nodes`` / ``mean_nodes`` / ``mean_over_max_nodes`` with the
    reference's axis conventions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvuld_tpu_torch.models.dropout import dropout

NEG_INF = -1e9
NEGATIVE_SLOPE = 0.2   # dgl GATConv's LeakyReLU slope


class DenseGATConv(nn.Module):
    """Graph attention over a dense boolean adjacency.

    adj[b, i, j] = True means an edge i → j; attention for destination j is
    normalized over its in-neighbors i (dgl.nn.GATConv convention). Output
    shape [B, N, num_heads, out_feats].
    """

    def __init__(self, in_feats: int, out_feats: int, num_heads: int = 4,
                 feat_drop: float = 0.0):
        super().__init__()
        self.out_feats, self.num_heads = out_feats, num_heads
        self.feat_drop = feat_drop
        self.fc = nn.Linear(in_feats, out_feats * num_heads, bias=False)
        self.attn_l = nn.Parameter(torch.empty(1, num_heads, out_feats))
        self.attn_r = nn.Parameter(torch.empty(1, num_heads, out_feats))
        self.bias = nn.Parameter(torch.zeros(num_heads * out_feats))
        nn.init.xavier_normal_(self.attn_l)
        nn.init.xavier_normal_(self.attn_r)

    def forward(self, h: torch.Tensor, adj: torch.Tensor,
                gen=None) -> torch.Tensor:
        B, N, _ = h.shape
        H, D = self.num_heads, self.out_feats
        z = self.fc(dropout(h, self.feat_drop, gen)).reshape(B, N, H, D)
        el = torch.einsum("bnhd,hd->bnh", z, self.attn_l[0])   # source term
        er = torch.einsum("bnhd,hd->bnh", z, self.attn_r[0])   # destination
        # scores[b, h, i, j] for edge i → j
        scores = (el.permute(0, 2, 1)[:, :, :, None]
                  + er.permute(0, 2, 1)[:, :, None, :])
        scores = F.leaky_relu(scores, NEGATIVE_SLOPE)
        mask = adj.bool()[:, None, :, :]                       # [B, 1, N, N]
        scores = torch.where(mask, scores, NEG_INF)
        alpha = torch.softmax(scores, dim=2)                   # over in-neighbors i
        alpha = torch.where(mask, alpha, 0.0)                  # rows with no edges → 0
        out = torch.einsum("bhij,bihd->bjhd", alpha, z)
        return out + self.bias.reshape(H, D)


BN_MOMENTUM = 0.99   # flax nn.BatchNorm's default


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d,
               train: bool = False) -> torch.Tensor:
    """flax ``BatchNorm``, features on dim 1 (torch layout).

    Eval: normalise with ``bn``'s running statistics. Train: normalise with
    the batch's statistics over every other dim, taken as flax takes them
    (fp32, or fp64 for fp64 x; var = max(E[x²] − E[x]², 0), the biased
    variance), and update the
    running statistics in place with flax's momentum 0.99:
    running = 0.99·running + 0.01·batch. Torch's own train path differs in
    both (momentum 0.1, unbiased running variance).

    Under data parallelism (``parallel.mesh.sync_batch_norm`` sets
    ``bn.process_group`` to the dp group) the statistics are the global
    batch's, as JAX's BatchNorm takes them over the sharded batch under
    jit: Σx and Σx² are summed over the group (differentiably) before the
    division."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1] * x.dim()
    shape[1] = -1
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    group = getattr(bn, "process_group", None)
    if group is None:
        mean = xf.mean(dims)
        var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
    else:
        from mvuld_tpu_torch.parallel.collectives import all_reduce_fn, size
        n = xf.numel() // xf.shape[1] * size(group)
        sums = all_reduce_fn(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]),
                             group)
        mean = sums[0] / n
        var = (sums[1] / n - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + bn.eps)
    return y * bn.weight.reshape(shape) + bn.bias.reshape(shape)


class RsGCN(nn.Module):
    """Non-local relational reasoning block (reference: Rs_GCN.py:7-73).

    Input/output layout is [B, N, C] (channels last); a 1×1 Conv1d over
    [B, C, N] is a dense layer over the channel axis. Returns
    (v_star, affinity).
    """

    def __init__(self, channels: int, inter_channels: int):
        super().__init__()
        C, Ci = channels, inter_channels
        self.g = nn.Conv1d(C, Ci, 1)
        self.theta = nn.Conv1d(C, Ci, 1)
        self.phi = nn.Conv1d(C, Ci, 1)
        self.W = nn.Sequential(nn.Conv1d(Ci, C, 1), nn.BatchNorm1d(C))
        # zero-init BN scale → identity residual at initialization
        nn.init.zeros_(self.W[1].weight)

    @staticmethod
    def _conv(x, conv: nn.Conv1d):
        return F.linear(x, conv.weight[:, :, 0], conv.bias)

    def forward(self, v: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, N, C = v.shape
        g_v = self._conv(v, self.g)                                # [B,N,Ci]
        theta = self._conv(v, self.theta)
        phi = self._conv(v, self.phi)
        # affinity over node pairs, divided by node count (Rs_GCN.py:66-68)
        R = torch.einsum("bic,bjc->bij", theta, phi) / N
        y = torch.einsum("bij,bjc->bic", R, g_v)                   # [B,N,Ci]
        w_y = self._conv(y, self.W[0])
        # torch BatchNorm1d over channels of [B, C, N]
        w_y = batch_norm(w_y.reshape(B * N, C), self.W[1], train
                         ).reshape(B, N, C)
        return w_y + v, R


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``'s parameter set and update: ``ir``, ``iz``,
    ``in`` dense with bias on the input, ``hr``, ``hz`` without bias and
    ``hn`` with bias on the state;
    r, z = σ(·), n = tanh(x_n + r·h_n), h' = (1 − z)·n + z·h.
    (``torch.nn.GRU`` would add hidden biases to r and z.)"""

    def __init__(self, d_in: int, features: int):
        super().__init__()
        for gate in ("r", "z", "n"):
            self.add_module(f"i{gate}", nn.Linear(d_in, features))
            self.add_module(f"h{gate}", nn.Linear(features, features,
                                                  bias=gate == "n"))

    def forward(self, h, x):
        m = self._modules
        r = torch.sigmoid(m["ir"](x) + m["hr"](h))
        z = torch.sigmoid(m["iz"](x) + m["hz"](h))
        n = torch.tanh(m["in"](x) + r * m["hn"](h))
        return (1.0 - z) * n + z * h


class DenseGGNN(nn.Module):
    """Gated graph conv over per-etype dense adjacency (the Devign
    baseline's GGNN, dgl GatedGraphConv semantics): per-etype linear
    messages ``etype_w`` [R, D, D], summed over in-edges src i → dst j,
    a flax-layout ``GRUCell`` state update, ``n_steps`` iterations. Inputs
    narrower than ``out_feats`` are zero-padded up to it."""

    def __init__(self, out_feats: int, n_steps: int = 6, n_etypes: int = 6):
        super().__init__()
        self.out_feats, self.n_steps = out_feats, n_steps
        self.etype_w = nn.Parameter(torch.empty(n_etypes, out_feats,
                                                out_feats))
        nn.init.xavier_uniform_(self.etype_w)
        self.gru = GRUCell(out_feats, out_feats)

    def forward(self, h: torch.Tensor, adj_etype: torch.Tensor,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """h [B, N, F_in], adj_etype [B, R, N, N] (src i → dst j) →
        [B, N, out_feats]."""
        B, N, F_in = h.shape
        D = self.out_feats
        if F_in > D:
            raise ValueError(
                f"GGNN requires in_feats ({F_in}) <= out_feats ({D}) — same "
                "constraint as dgl.nn.GatedGraphConv")
        if F_in < D:
            h = F.pad(h, (0, D - F_in))
        for _ in range(self.n_steps):
            m = torch.einsum("bnd,rde->brne", h, self.etype_w)
            agg = torch.einsum("brij,brid->bjd", adj_etype, m)
            h = self.gru(h.reshape(B * N, D), agg.reshape(B * N, D)
                         ).reshape(B, N, D)
        if node_mask is not None:
            h = h * node_mask[..., None]
        return h


def l2norm_nodes(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize over the NODE axis (dim=1) — the reference's l2norm
    (GraphModel.py:76-80) normalizes dim 1 of [B, N, D]."""
    return x / torch.sqrt((x * x).sum(dim=1, keepdim=True) + eps)


def mean_nodes(h: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """dgl.mean_nodes: mean over VALID nodes only (used by the ablation
    models via dgl's readout, GraphModel.py:296-299)."""
    m = node_mask[..., None]
    return (h * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


def mean_over_max_nodes(h: torch.Tensor) -> torch.Tensor:
    """The production model's readout: plain mean over the padded node axis —
    torch.mean(dim=1) divides by max_node regardless of validity
    (GraphModel.py:204). Kept verbatim for parity."""
    return h.mean(dim=1)
