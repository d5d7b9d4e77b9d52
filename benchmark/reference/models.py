"""Plain PyTorch reference of the measured models, frozen with the benchmark.

Three towers and the head the benchmark's cells train and serve:

* ``Roberta``: the UniXcoder-base encoder (post-LN RoBERTa; token, position
  and token-type embeddings; exact-erf GELU);
* ``SwinV2``: SwinV2 with cosine window attention, the log-spaced
  continuous position bias and post-norm residuals (Liu et al. 2022,
  "Swin Transformer V2"), with an optional classification head;
* ``FusionHead``: the ``multi_defect_new_gcn`` head (modality projections,
  two 4-head GATs, eight hidden layers, the split node/box projection,
  eight Rs-GCN blocks, the padded-node mean, the final BatchNorm and FC);
* ``EndToEnd``: the three joined as the tri-modal model.

Every activation is fp32 and every product runs through ``mm`` so that
the control can compute the same model in a lower precision
(``Precision``). Module and parameter names follow the checkpoints'
names (HF ``RobertaModel``, the SwinV2 reference code, the head's torch
layout), so one table of seeded weights keyed by name loads into this
reference and into the system under test alike. The dropout and
stochastic-depth masks are passed in (``Masks``), drawn by the caller.

This file imports torch and numpy only.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Precision:
    """The products' precision: ``fp32`` (TF32 off: the reference),
    ``fp8`` (each operand of every product rounded to e4m3 with a
    per-tensor scale, the accumulation fp32: the control one step below
    the bf16 the configurations state) or ``bf16`` (each operand rounded
    to bf16: a look at what bf16 operands alone do, not a control)."""

    mode = "fp32"

    @classmethod
    def cast(cls, x: torch.Tensor) -> torch.Tensor:
        if cls.mode == "fp32":
            return x
        if cls.mode == "bf16":
            return _Bf16Round.apply(x)
        if cls.mode != "fp8":
            raise ValueError(f"unknown precision {cls.mode!r}")
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = 448.0 / amax
        return _Fp8Round.apply(x, scale)


class _Fp8Round(torch.autograd.Function):
    """x rounded to e4m3 at ``scale`` (straight-through gradient, the
    gradient rounded the same way)."""

    @staticmethod
    def forward(ctx, x, scale):
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        amax = g.abs().amax().clamp_min(1e-30)
        s = 448.0 / amax
        return (g * s).to(torch.float8_e4m3fn).to(g.dtype) / s, None


class _Bf16Round(torch.autograd.Function):
    """x rounded to bf16 (the gradient rounded the same way)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b at the reference's precision."""
    return Precision.cast(a) @ Precision.cast(b)


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    y = mm(x, layer.weight.t())
    return y if layer.bias is None else y + layer.bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def keep_apply(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float
               ) -> torch.Tensor:
    """Dropout with a given keep-mask: kept elements divided by 1 − rate."""
    if mask is None or rate == 0.0:
        return x
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


class Masks:
    """The masks of one forward, consumed in the order they were drawn."""

    def __init__(self, masks: Optional[Sequence] = None):
        self.masks = list(masks) if masks is not None else None
        self.pos = 0

    def next(self):
        if self.masks is None:
            return None
        m = self.masks[self.pos]
        self.pos += 1
        return m


# --------------------------------------------------------------- RoBERTa

class _SelfAttn(nn.Module):
    def __init__(self, H: int):
        super().__init__()
        self.query, self.key, self.value = nn.Linear(H, H), nn.Linear(H, H), nn.Linear(H, H)


class _DenseLN(nn.Module):
    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)


class _Attention(nn.Module):
    def __init__(self, H: int, eps: float):
        super().__init__()
        self.self = _SelfAttn(H)
        self.output = _DenseLN(H, H, eps)


class _Intermediate(nn.Module):
    def __init__(self, H: int, I: int):
        super().__init__()
        self.dense = nn.Linear(H, I)


class _Layer(nn.Module):
    def __init__(self, H: int, I: int, eps: float):
        super().__init__()
        self.attention = _Attention(H, eps)
        self.intermediate = _Intermediate(H, I)
        self.output = _DenseLN(I, H, eps)


class _Embeddings(nn.Module):
    def __init__(self, V: int, H: int, P: int, types: int, eps: float):
        super().__init__()
        self.word_embeddings = nn.Embedding(V, H)
        self.position_embeddings = nn.Embedding(P, H)
        self.token_type_embeddings = nn.Embedding(types, H)
        self.LayerNorm = nn.LayerNorm(H, eps=eps)


class _Encoder(nn.Module):
    def __init__(self, L: int, H: int, I: int, eps: float):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(H, I, eps) for _ in range(L))


class Roberta(nn.Module):
    """RoBERTa encoder → last hidden state [B, T, H]. ``forward(ids,
    masks)``: ``masks`` yields, when training, the embedding dropout mask,
    then per layer the attention probabilities', the attention output's and
    the MLP output's masks."""

    def __init__(self, vocab: int, hidden: int = 768, layers: int = 12,
                 heads: int = 12, intermediate: int = 3072,
                 max_positions: int = 1026, type_vocab: int = 10,
                 pad_id: int = 1, eps: float = 1e-5, rate: float = 0.1):
        super().__init__()
        self.heads, self.pad_id, self.rate = heads, pad_id, rate
        self.embeddings = _Embeddings(vocab, hidden, max_positions,
                                      type_vocab, eps)
        self.encoder = _Encoder(layers, hidden, intermediate, eps)

    def forward(self, ids: torch.Tensor, masks: Masks) -> torch.Tensor:
        e = self.embeddings
        live = (ids != self.pad_id).long()
        pos = torch.cumsum(live, -1) * live + self.pad_id
        h = (e.word_embeddings.weight[ids] + e.position_embeddings.weight[pos]
             + e.token_type_embeddings.weight[0])
        h = keep_apply(e.LayerNorm(h), masks.next(), self.rate)
        bias = torch.where(live[:, None, None, :] > 0, 0.0, -1e9)
        B, T, H = h.shape
        hd = H // self.heads
        for layer in self.encoder.layer:
            a = layer.attention

            def split(lin):
                return dense(h, lin).reshape(B, T, self.heads, hd).transpose(1, 2)

            q, k, v = split(a.self.query), split(a.self.key), split(a.self.value)
            p = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
                              + bias, dim=-1)
            p = keep_apply(p, masks.next(), self.rate)
            ctx = mm(p, v).transpose(1, 2).reshape(B, T, H)
            out = keep_apply(dense(ctx, a.output.dense), masks.next(),
                             self.rate)
            h = a.output.LayerNorm(h + out)
            m = dense(gelu(dense(h, layer.intermediate.dense)),
                      layer.output.dense)
            h = layer.output.LayerNorm(h + keep_apply(m, masks.next(),
                                                      self.rate))
        return h


def masked_mean(x: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    m = live.to(x.dtype)[..., None]
    return (x * m).sum(1) / m.sum(1).clamp_min(1.0)


# ----------------------------------------------------------------- SwinV2

def coords_table(ws: int, pretrained: int) -> np.ndarray:
    h = np.arange(-(ws - 1), ws, dtype=np.float64)
    t = np.stack(np.meshgrid(h, h, indexing="ij"), -1)
    t = t / max((pretrained - 1) if pretrained > 0 else (ws - 1), 1) * 8
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8)
    return t.reshape(-1, 2).astype(np.float32)


def position_index(ws: int) -> np.ndarray:
    c = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    c = c.reshape(2, -1)
    r = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (r[..., 0] * (2 * ws - 1) + r[..., 1]).reshape(-1)


def shift_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    img = np.zeros((H, W), np.int64)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    m = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    return np.where(m[:, None, :] != m[:, :, None], -100.0, 0.0
                    ).astype(np.float32)


def windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def unwindows(x: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(-1, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, H, W, C)


class _WindowAttn(nn.Module):
    def __init__(self, dim, heads, ws, pretrained):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.logit_scale = nn.Parameter(torch.zeros(heads, 1, 1))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                     nn.Linear(512, heads, bias=False))
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("table", torch.as_tensor(coords_table(ws, pretrained)),
                             persistent=False)
        self.register_buffer("index", torch.as_tensor(position_index(ws)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        B, Hp, Wp, C = x.shape
        ws, H = self.ws, self.heads
        N, hd = ws * ws, C // H
        b = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = windows(mm(x, self.qkv.weight.t()) + b, ws)
        Bn = qkv.shape[0]
        q, k, v = qkv.reshape(Bn, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q = F.normalize(q, dim=-1, eps=1e-12)
        k = F.normalize(k, dim=-1, eps=1e-12)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        cpb = dense(F.relu(dense(self.table, self.cpb_mlp[0])), self.cpb_mlp[2])
        bias = 16 * torch.sigmoid(cpb[self.index].reshape(N, N, H).permute(2, 0, 1))
        a = mm(q, k.transpose(-1, -2)) * scale + bias
        if mask is not None:
            nW = mask.shape[0]
            a = (a.reshape(Bn // nW, nW, H, N, N) + mask[None, :, None]
                 ).reshape(Bn, H, N, N)
        out = mm(torch.softmax(a, -1), v).permute(0, 2, 1, 3).reshape(Bn, N, C)
        return dense(unwindows(out, ws, Hp, Wp), self.proj)


class _Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(dim, hidden), nn.Linear(hidden, dim)


class _Block(nn.Module):
    def __init__(self, dim, res, heads, ws, shift, pretrained):
        super().__init__()
        if res <= ws:
            ws, shift = res, 0
        self.res, self.ws, self.shift = res, ws, shift
        self.attn = _WindowAttn(dim, heads, ws, pretrained)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, 4 * dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        m = shift_mask(res, res, ws, shift) if shift else None
        self.register_buffer("mask", None if m is None else torch.as_tensor(m),
                             persistent=False)

    def forward(self, x, drop):
        B, L, C = x.shape
        r, s = self.res, self.shift
        y = x.reshape(B, r, r, C)
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = self.attn(y, self.mask)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + drop_path(self.norm1(y.reshape(B, L, C)), drop, 0)
        m = dense(gelu(dense(x, self.mlp.fc1)), self.mlp.fc2)
        return x + drop_path(self.norm2(m), drop, 1)


def drop_path(x, drop, which):
    if drop is None:
        return x
    keep = drop[which].reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x / (1.0 - drop[2]), torch.zeros_like(x))


class _Merge(nn.Module):
    def __init__(self, res, dim):
        super().__init__()
        self.res = res
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=1e-6)

    def forward(self, x):
        B, L, C = x.shape
        r = self.res
        x = x.reshape(B, r // 2, 2, r // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        x = torch.cat([x[:, :, :, 0, 0], x[:, :, :, 0, 1], x[:, :, :, 1, 0],
                       x[:, :, :, 1, 1]], -1).reshape(B, L // 4, 4 * C)
        return self.norm(mm(x, self.reduction.weight.t()))


class _Stage(nn.Module):
    def __init__(self, blocks, down):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = down


class _PatchEmbed(nn.Module):
    def __init__(self, patch, chans, dim):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(chans, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        """x NHWC → [B, L, dim], the strided convolution as a product over
        each patch's pixels."""
        B, S, _, Ci = x.shape
        p = self.patch
        x = x.reshape(B, S // p, p, S // p, p, Ci).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, (S // p) ** 2, Ci * p * p)
        w = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        return self.norm(mm(x, w.t()) + self.proj.bias)


class SwinV2(nn.Module):
    """``forward(x NHWC, drops)`` → the pooled features [B, num_features],
    or with ``num_classes`` the head's logits. ``drops``: per block None or
    (keep-mask of the attention half [B], of the MLP half [B], rate)."""

    def __init__(self, img=448, patch=4, chans=3, embed=128,
                 depths=(2, 2, 18, 2), heads=(4, 8, 16, 32), window=28,
                 pretrained=(0, 0, 0, 0), drop_path_rate=0.2,
                 num_classes=0):
        super().__init__()
        self.depths, self.drop_path_rate = tuple(depths), drop_path_rate
        self.patch_embed = _PatchEmbed(patch, chans, embed)
        res = img // patch
        stages = []
        for i, d in enumerate(depths):
            dim, r = embed * 2 ** i, res // 2 ** i
            blocks = [_Block(dim, r, heads[i], window,
                             0 if j % 2 == 0 else window // 2, pretrained[i])
                      for j in range(d)]
            stages.append(_Stage(blocks, _Merge(r, dim)
                                 if i < len(depths) - 1 else None))
        self.layers = nn.ModuleList(stages)
        self.num_features = embed * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.num_features, eps=1e-6)
        self.head = nn.Linear(self.num_features, num_classes) if num_classes else None

    def rates(self) -> List[float]:
        return np.linspace(0, self.drop_path_rate, sum(self.depths)).tolist()

    def forward(self, x, drops=None):
        x = self.patch_embed(x)
        i = 0
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x, None if drops is None else drops[i])
                i += 1
            if stage.downsample is not None:
                x = stage.downsample(x)
        x = self.norm(x).mean(1)
        return x if self.head is None else dense(x, self.head)


# -------------------------------------------------------------- the head

def batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, train: bool,
               momentum: float = 0.99) -> torch.Tensor:
    """Features on dim 1; training takes the batch's statistics (biased
    variance E[x²] − E[x]²) and moves the running ones by 1 − momentum."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1] * x.dim()
    shape[1] = -1
    mean = x.mean(dims)
    var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.mul_(momentum).add_((1 - momentum) * mean)
        bn.running_var.mul_(momentum).add_((1 - momentum) * var)
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + bn.eps)
    return y * bn.weight.reshape(shape) + bn.bias.reshape(shape)


class _ProjBNFC(nn.Module):
    def __init__(self, d_in, out):
        super().__init__()
        self.bn = nn.BatchNorm1d(d_in, eps=1e-5)
        self.fc = nn.Linear(d_in, out)

    def forward(self, x, train):
        return F.elu(dense(batch_norm(x, self.bn, train), self.fc))


class _GAT(nn.Module):
    def __init__(self, d_in, out, heads):
        super().__init__()
        self.out, self.heads = out, heads
        self.fc = nn.Linear(d_in, out * heads, bias=False)
        self.attn_l = nn.Parameter(torch.zeros(1, heads, out))
        self.attn_r = nn.Parameter(torch.zeros(1, heads, out))
        self.bias = nn.Parameter(torch.zeros(heads * out))

    def forward(self, h, adj, mask, rate):
        B, N, _ = h.shape
        z = mm(keep_apply(h, mask, rate), self.fc.weight.t()
               ).reshape(B, N, self.heads, self.out)
        el = (z * self.attn_l[0]).sum(-1).permute(0, 2, 1)      # [B, H, N]
        er = (z * self.attn_r[0]).sum(-1).permute(0, 2, 1)
        s = F.leaky_relu(el[:, :, :, None] + er[:, :, None, :], 0.2)
        edge = adj[:, None]
        s = torch.where(edge, s, torch.full_like(s, -1e9))
        alpha = torch.where(edge, torch.softmax(s, 2), torch.zeros_like(s))
        out = mm(alpha.transpose(-1, -2), z.permute(0, 2, 1, 3))  # [B,H,N,D]
        return out.permute(0, 2, 1, 3) + self.bias.reshape(self.heads, self.out)


class _GATStack(nn.Module):
    def __init__(self, d_in, hidden, heads):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.gat = _GAT(d_in, hidden, heads)
        self.gat2 = _GAT(hidden * heads, hidden, heads)
        self.fc = nn.Linear(hidden * heads, hidden)


class _Hidden(nn.Module):
    def __init__(self, d, depth):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"fc_{i}", nn.Linear(d, d))


class _RsGCN(nn.Module):
    def __init__(self, C):
        super().__init__()
        self.g, self.theta, self.phi = (nn.Conv1d(C, C, 1), nn.Conv1d(C, C, 1),
                                        nn.Conv1d(C, C, 1))
        self.W = nn.Sequential(nn.Conv1d(C, C, 1), nn.BatchNorm1d(C, eps=1e-5))

    def forward(self, v, train):
        B, N, C = v.shape

        def conv(x, c):
            return mm(x, c.weight[:, :, 0].t()) + c.bias

        g, th, ph = conv(v, self.g), conv(v, self.theta), conv(v, self.phi)
        R = mm(th, ph.transpose(1, 2)) / N
        wy = conv(mm(R, g), self.W[0])
        wy = batch_norm(wy.reshape(B * N, C), self.W[1], train).reshape(B, N, C)
        return wy + v


class _Graph(nn.Module):
    def __init__(self, d_in, max_nodes, pos_dim, hidden, heads, depth, rs):
        super().__init__()
        self.depth, self.rs = depth, rs
        self.gats = _GATStack(d_in, hidden, heads)
        self.hidden = _Hidden(hidden, depth)
        self.bn_gat = nn.BatchNorm1d(max_nodes, eps=1e-5)
        self.fc_gat = nn.Linear(hidden, hidden - 32)
        self.bn_bbox = nn.BatchNorm1d(max_nodes, eps=1e-5)
        self.fc_bbox = nn.Linear(pos_dim, 32)
        for i in range(rs):
            self.add_module(f"rs_gcn_{i}", _RsGCN(hidden))

    def forward(self, h, pos, adj, node_mask, train, masks: Masks,
                rate: float):
        B, N, _ = h.shape
        g = self.gats
        h = g.gat(h, adj, masks.next(), rate).reshape(B, N, -1)
        h = g.gat2(h, adj, masks.next(), rate).reshape(B, N, -1)
        h = keep_apply(F.elu(dense(h, g.fc)), masks.next(), rate)
        for i in range(self.depth):
            h = keep_apply(F.elu(dense(h, getattr(self.hidden, f"fc_{i}"))),
                           masks.next(), rate)
        h = h * node_mask[..., None]
        hi = F.elu(dense(batch_norm(h, self.bn_gat, train), self.fc_gat))
        pi = F.elu(dense(batch_norm(pos, self.bn_bbox, train), self.fc_bbox))
        h = torch.cat([hi, pi], -1)
        for i in range(self.rs):
            h = getattr(self, f"rs_gcn_{i}")(h, train)
        h = h / torch.sqrt((h * h).sum(1, keepdim=True) + 1e-12)
        return h.mean(1)


class FusionHead(nn.Module):
    """``multi_defect_new_gcn``: image, graph and text features → logits."""

    def __init__(self, img_dim=1024, text_dim=768, hidden=512, heads=4,
                 depth=8, rs=8, max_nodes=100, pos_dim=4, classes=2,
                 rate=0.2):
        super().__init__()
        self.rate = rate
        self.img_proj = _ProjBNFC(img_dim, hidden)
        self.graph = _Graph(text_dim, max_nodes, pos_dim, hidden, heads,
                            depth, rs)
        self.text_proj = _ProjBNFC(text_dim, hidden)
        self.final_bn = nn.BatchNorm1d(3 * hidden, eps=1e-5)
        self.final_fc = nn.Linear(3 * hidden, classes)

    def forward(self, img, text, node, pos, adj, node_mask, train: bool,
                masks: Masks):
        f = torch.cat([self.img_proj(img, train),
                       self.graph(node, pos, adj, node_mask, train, masks,
                                  self.rate),
                       self.text_proj(text, train)], -1)
        return dense(batch_norm(f, self.final_bn, train), self.final_fc)


class EndToEnd(nn.Module):
    """The tri-modal model: ``text_encoder`` (function text and each code
    line through one encoder), ``swin`` (the rendered graph) and
    ``fusion``. The towers run in blocks and the head on whole batches:
    ``benchmark/reference/steps.py``."""

    def __init__(self, text: dict, swin: dict, head: dict):
        super().__init__()
        self.text_encoder = Roberta(**text)
        self.swin = SwinV2(**swin)
        self.fusion = FusionHead(**head)
