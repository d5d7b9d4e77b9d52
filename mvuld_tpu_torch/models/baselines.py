"""Baseline detectors in PyTorch: Devign, ReVeal, IVDetect.

Counterpart of ``mvuld_tpu/models/baselines.py`` over the same dense
[B, N, ·] layout (reference semantics there):

  * ``DevignModel`` — 6-step GGNN over 132-d nodes (word2vec 100 + node
    type one-hot 32), dual Conv1d/MaxPool readout over the node axis,
    elementwise product, mean → logits [B];
  * ``GGNNSum`` — ReVeal phase 1: 8-step GGNN, sum readout, linear;
  * ``MetricLearningModel`` / ``reveal_loss`` / ``smote`` — ReVeal phase 2
    over SMOTE-rebalanced representations;
  * ``MaskedGRU``, ``ChildSumTreeLSTM`` and ``IVDetect`` — five per-node
    channels → BiGRU across channels → Linear → GraphConv(→2) → mean-pool.

Module names follow the flax trees (``ggnn``, ``y_conv1``, ``mlp_z``,
``gru_subseq``, ``treelstm``, ``bigru_fwd`` …); ``models/convert.py`` maps
the leaves (flax Conv [k, Cin, Cout] → Conv1d [Cout, Cin, k], the RNN's
``GRUCell_0`` → ``cell``). Torch needs every width up front where flax
infers it from the input: ``MetricLearningModel`` takes ``input_dim`` and
``IVDetect``'s channels read ``feat_dim``. Dropout masks come from an
explicit generator (``models/dropout.py``), or, for the metric learner,
as keep-masks the caller draws once and applies to several passes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mvuld_tpu_torch.models.dropout import apply_keep, dropout, keep_mask
from mvuld_tpu_torch.models.graph_nets import DenseGGNN, GRUCell, mean_nodes


def _conv_pool(y: torch.Tensor, conv1: nn.Conv1d, conv2: nn.Conv1d
               ) -> torch.Tensor:
    """[B, N, C] → Conv1d(k=3, VALID) → ReLU → MaxPool1d(3, 2) → Conv1d(1)
    → ReLU → MaxPool1d(2, 2) over the node axis → [B, N', C]."""
    y = F.max_pool1d(F.relu(conv1(y.transpose(1, 2))), 3, 2)
    y = F.max_pool1d(F.relu(conv2(y)), 2, 2)
    return y.transpose(1, 2)


class DevignModel(nn.Module):
    """GGNN + dual Conv1d/MaxPool readout (reference: devign/model.py)."""

    def __init__(self, input_dim: int = 132, output_dim: int = 200,
                 num_steps: int = 6, n_etypes: int = 6):
        super().__init__()
        D, C = output_dim, output_dim + input_dim
        self.ggnn = DenseGGNN(D, num_steps, n_etypes)
        self.y_conv1, self.y_conv2 = nn.Conv1d(D, D, 3), nn.Conv1d(D, D, 1)
        self.z_conv1, self.z_conv2 = nn.Conv1d(C, C, 3), nn.Conv1d(C, C, 1)
        self.mlp_y, self.mlp_z = nn.Linear(D, 1), nn.Linear(C, 1)

    def forward(self, node_feats: torch.Tensor, adj_etype: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        """node_feats [B,N,F], adj_etype [B,R,N,N] → logits [B]."""
        h = self.ggnn(node_feats, adj_etype, node_mask)
        c = torch.cat([h, node_feats * node_mask[..., None]], dim=-1)
        Y = _conv_pool(h, self.y_conv1, self.y_conv2)
        Z = _conv_pool(c, self.z_conv1, self.z_conv2)
        return (self.mlp_y(Y) * self.mlp_z(Z)).mean(dim=1).squeeze(-1)


class GGNNSum(nn.Module):
    """ReVeal phase-1 encoder (reference: reveal/ggnn/model.py:8-60)."""

    def __init__(self, output_dim: int = 200, num_steps: int = 8,
                 n_etypes: int = 6):
        super().__init__()
        self.ggnn = DenseGGNN(output_dim, num_steps, n_etypes)
        self.classifier = nn.Linear(output_dim, 1)

    def forward(self, node_feats: torch.Tensor, adj_etype: torch.Tensor,
                node_mask: torch.Tensor, return_repr: bool = False):
        h_sum = self.ggnn(node_feats, adj_etype, node_mask).sum(dim=1)
        logits = self.classifier(h_sum).squeeze(-1)
        if return_repr:
            return logits, h_sum
        return logits


class MetricLearningModel(nn.Module):
    """ReVeal phase-2 representation learner (reference: reveal/model.py).
    ``forward(x, keep)`` returns (log_probs [B,2], features [B,H]); with
    ``keep`` (from ``keep_masks``) the dropouts drop, else none does."""

    def __init__(self, input_dim: int, hidden_dim: int = 256,
                 dropout_p: float = 0.2, num_layers: int = 1):
        super().__init__()
        H = hidden_dim
        self.hidden_dim, self.p, self.num_layers = H, dropout_p, num_layers
        self.layer1 = nn.Linear(input_dim, H)
        for i in range(num_layers):
            self.add_module(f"feat_{i}_a", nn.Linear(H, H // 2))
            self.add_module(f"feat_{i}_b", nn.Linear(H // 2, H))
        self.classifier = nn.Linear(H, 2)

    def keep_masks(self, batch: int, gen: torch.Generator, device
                   ) -> List[torch.Tensor]:
        """One keep-mask per dropout, in the order ``forward`` applies
        them; passes given the same masks drop the same units (as flax
        does under one dropout key)."""
        H = self.hidden_dim
        widths = [H] + [H // 2, H] * self.num_layers
        return [keep_mask((batch, w), self.p, gen, device) for w in widths]

    def forward(self, x: torch.Tensor,
                keep: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        masks = iter(keep or ())

        def drop(t):
            return apply_keep(t, next(masks), self.p) if keep else t

        h = drop(F.relu(self.layer1(x)))
        for i in range(self.num_layers):
            inner = drop(F.relu(getattr(self, f"feat_{i}_a")(h)))
            h = drop(F.relu(getattr(self, f"feat_{i}_b")(inner)))
        return F.log_softmax(self.classifier(h), dim=-1), h


def reveal_loss(logp_a, h_a, targets, h_p=None, h_n=None,
                alpha: float = 0.5, lambda1: float = 0.5,
                lambda2: float = 0.001) -> torch.Tensor:
    """CE + cosine triplet + L2 magnitude (reference: reveal/model.py:47-78)."""
    ce = -torch.gather(logp_a, -1, targets.long()[:, None]).squeeze(-1)
    if h_p is None or h_n is None:
        return ce.sum()

    def cos_dist(a, b):
        num = (a * b).sum(-1)
        return 1.0 - num / (torch.linalg.norm(a, dim=-1)
                            * torch.linalg.norm(b, dim=-1) + 1e-8)

    trip = lambda1 * torch.abs(cos_dist(h_a, h_p) - cos_dist(h_a, h_n)
                               + alpha)
    l2 = lambda2 * (torch.linalg.norm(h_a, dim=-1)
                    + torch.linalg.norm(h_p, dim=-1)
                    + torch.linalg.norm(h_n, dim=-1))
    return (ce + trip + l2).sum()


def smote(features, labels, rng, k: int = 5):
    """Numpy SMOTE (imblearn replacement): oversample the minority class by
    interpolating toward random same-class k-NN neighbors (reference uses
    imblearn.SMOTE, reveal/graph_dataset.py:47-60)."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    classes, counts = np.unique(labels, return_counts=True)
    if len(classes) < 2:
        return features, labels
    minority = classes[np.argmin(counts)]
    need = int(counts.max() - counts.min())
    minority_feats = features[labels == minority]
    if need == 0 or len(minority_feats) < 2:
        return features, labels
    d2 = ((minority_feats[:, None] - minority_feats[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    knn = np.argsort(d2, axis=1)[:, :min(k, len(minority_feats) - 1)]
    synth = []
    for _ in range(need):
        i = rng.randint(len(minority_feats))
        j = knn[i][rng.randint(knn.shape[1])]
        gap = rng.rand()
        synth.append(minority_feats[i] + gap * (minority_feats[j] - minority_feats[i]))
    synth = np.stack(synth)
    return (np.concatenate([features, synth]),
            np.concatenate([labels, np.full(need, minority, labels.dtype)]))


# --------------------------------------------------------------------------- #
# IVDetect
# --------------------------------------------------------------------------- #

class MaskedGRU(nn.Module):
    """GRU over [B*, L, D] sequences with a length mask; returns the state
    after each sequence's last valid step, as flax ``nn.RNN(seq_lengths=…,
    return_carry=True)`` selects it: at index length − 1, so a length-0 row
    (a padding node) takes the state after all L steps, as −1 indexes."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.cell = GRUCell(d_in, hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        L = x.shape[1]
        lengths = mask.sum(dim=-1).long()
        steps = torch.where(lengths > 0, lengths, L)[:, None]
        h = x.new_zeros(x.shape[0], self.hidden)
        for t in range(L):
            h = torch.where(t < steps, self.cell(h, x[:, t]), h)
        return h


class ChildSumTreeLSTM(nn.Module):
    """Child-sum TreeLSTM over the line-containment AST (reference:
    ivdetect/treeLstm.py:1-115). Children have larger line indices than
    their parent, so one reverse-order loop over the N nodes processes
    children before parents. The raw parameters keep the flax names and
    layouts ([in, out])."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        H = hidden
        self.hidden = H
        self.W_iou = nn.Parameter(torch.empty(d_in, 3 * H))
        self.b_iou = nn.Parameter(torch.zeros(3 * H))
        self.U_iou = nn.Parameter(torch.empty(H, 3 * H))
        self.W_f = nn.Parameter(torch.empty(d_in, H))
        self.b_f = nn.Parameter(torch.zeros(H))
        self.U_f = nn.Parameter(torch.empty(H, H))
        for p in (self.W_iou, self.U_iou, self.W_f, self.U_f):
            nn.init.xavier_uniform_(p)

    def forward(self, x: torch.Tensor, ast_adj: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        """x [B,N,D], ast_adj [B,N,N] (parent→child) → h [B,N,H]."""
        B, N, _ = x.shape
        h_all = x.new_zeros(B, N, self.hidden)
        c_all = x.new_zeros(B, N, self.hidden)
        x_iou = x @ self.W_iou + self.b_iou          # [B, N, 3H]
        x_f = x @ self.W_f + self.b_f                # [B, N, H]
        nodes = torch.arange(N, device=x.device)
        for j in range(N - 1, -1, -1):
            children = ast_adj[:, j]                 # [B, N]
            h_sum = torch.einsum("bn,bnh->bh", children, h_all)
            i, o, u = (x_iou[:, j] + h_sum @ self.U_iou).chunk(3, dim=-1)
            i, o, u = torch.sigmoid(i), torch.sigmoid(o), torch.tanh(u)
            f = torch.sigmoid(x_f[:, j, None, :] + h_all @ self.U_f)
            c_j = i * u + torch.einsum("bn,bnh->bh", children, f * c_all)
            h_j = o * torch.tanh(c_j)
            h_all = h_all.index_copy(1, nodes[j:j + 1], h_j[:, None])
            c_all = c_all.index_copy(1, nodes[j:j + 1], c_j[:, None])
        return h_all * node_mask[..., None]


class IVDetect(nn.Module):
    """Five-channel per-node features → BiGRU over channels → GraphConv →
    masked mean-pool (reference: ivdetect/model.py:120-285)."""

    def __init__(self, hidden: int = 64, feat_dim: int = 100):
        super().__init__()
        H = hidden
        self.hidden = H
        for name in ("gru_subseq", "gru_nametype", "gru_data",
                     "gru_control"):
            self.add_module(name, MaskedGRU(feat_dim, H))
        self.treelstm = ChildSumTreeLSTM(H, H)
        self.bigru_fwd, self.bigru_bwd = GRUCell(H, H), GRUCell(H, H)
        self.connect = nn.Linear(5 * 2 * H, H)
        self.gcn = nn.Linear(H, 2)

    def forward(self, f_subseq, f_subseq_mask, f_nametype, f_nametype_mask,
                f_data, f_data_mask, f_control, f_control_mask,
                ast_adj, adj, node_mask,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """f_* are [B, N, L, D] token-embedding sequences with [B, N, L]
        masks; ast_adj/adj are [B, N, N]; returns logits [B, 2]. ``gen``
        draws the Dropout(0.5) mask (training); None leaves it off."""
        B, N, L, D = f_subseq.shape
        H = self.hidden

        def seq_channel(seq, mask, gru):
            return gru(seq.reshape(B * N, L, D),
                       mask.reshape(B * N, L)).reshape(B, N, H)

        F1 = seq_channel(f_subseq, f_subseq_mask, self.gru_subseq)
        F2 = self.treelstm(F1, ast_adj, node_mask)
        F3 = seq_channel(f_nametype, f_nametype_mask, self.gru_nametype)
        F4 = seq_channel(f_data, f_data_mask, self.gru_data)
        F5 = seq_channel(f_control, f_control_mask, self.gru_control)
        flat = torch.stack([F1, F2, F3, F4, F5], dim=2).reshape(B * N, 5, H)

        def run(cell, xs):
            h = xs.new_zeros(B * N, H)
            outs = []
            for t in range(5):
                h = cell(h, xs[:, t])
                outs.append(h)
            return torch.stack(outs, dim=1)

        fwd = run(self.bigru_fwd, flat)
        bwd = run(self.bigru_bwd, flat.flip(1)).flip(1)
        bi = dropout(torch.cat([fwd, bwd], dim=-1), 0.5, gen)
        vec = self.connect(bi.reshape(B * N, 5 * 2 * H)).reshape(B, N, H)

        # GraphConv(H→2) with symmetric normalization over the full graph
        deg = adj.sum(-1, keepdim=True).clamp_min(1)
        msg = torch.einsum("bij,bjh->bih",
                           adj / torch.sqrt(deg * deg.transpose(1, 2)),
                           self.gcn(vec))
        return mean_nodes(msg * node_mask[..., None], node_mask)
