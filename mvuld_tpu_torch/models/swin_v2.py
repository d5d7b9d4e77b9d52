"""Swin Transformer V2 in PyTorch — the image-modality backbone.

Counterpart of ``mvuld_tpu/models/swin_v2.py`` (post-norm SwinV2; reference
mvuld/models/swin_transformer_v2.py). Module and parameter
names are the reference torch ones (``layers.{i}.blocks.{j}.attn.qkv``,
``attn.cpb_mlp.0``, ``norm1`` …) so ``models/convert.py`` maps the JAX
variables onto them one to one.

Activations run in ``config.dtype`` (bf16 for serving) with fp32
parameters, as in the JAX package: dense layers cast their input and weights
to the compute dtype, LayerNorm takes its statistics in fp32 and returns the
compute dtype, the attention softmax and the CPB bias stay fp32.

``use_pallas`` selects the flat-layout attention kernel
(``ops/window_attention.py``, K1) and ``use_pallas_mlp`` the fused MLP+LN
kernel (``ops/fused_dense.py`` ``mlp_ln``, K3, stages with C ≤ 512), under
the JAX package's flag names; with gradients enabled the attention runs as
``flat_attention`` (K1 forward with row sums and K2 backward, or under
``MVULD_ATTN_BWD=v1`` K1 forward and K5 backward) and the MLP half as the
``mlp_ln`` autograd function (K3 forward, K3b backward). Off, the
blocks run the plain composition of the JAX XLA branch (exact softmax, q/k
divided by max(‖·‖, 1e-12)) and autograd differentiates it.

Training (``forward(x, train=True, gen=...)``) adds per-image DropPath with
the per-block rates ``linspace(0, drop_path_rate, Σdepths)``, its masks
drawn from ``gen`` for a whole stage before the stage runs, and
``torch.utils.checkpoint`` over the stages in ``remat_stages``. With
``drop_rate`` (MODEL.DROP_RATE) > 0 it also drops out, where the JAX model
does, the patch embedding, the MLP after GELU and after fc2, and the
attention's projection; with ``attn_drop_rate`` > 0 (no config key, as in
JAX) the attention probabilities. Those masks come from ``gen`` too; a
checkpointed stage draws them through a ``StageRng`` (``models/dropout.py``),
so its recomputation drops the same elements. The kernel
paths follow JAX's conditions: ``drop_rate`` > 0 runs the plain MLP (not
K3/K3b), ``attn_drop_rate`` > 0 the plain attention (not K1/K2/K5), and
dropout on the projection alone keeps the attention kernel. Under
checkpointing the recomputed forward reuses the first forward's K1 output
(and, under v2, its row sums: the JAX remat policy's saved ``attn_out`` /
``attn_rowsum``), so K1 never runs twice under either backward generation,
and the DropPath masks are the same in both passes.

``num_classes`` > 0 adds the classification head (``head``, fp32) and the
forward returns its logits, the JAX model without ``return_features``: the
SwinV2 fine-tune (``train/train_swin.py``) trains it.

``sequence_parallel(model, group)`` is the JAX ``PallasOpts.sp_mesh`` /
``sp_axis``: the kernel path's attention runs
``window_attention_flat_sharded`` over the group, each rank K1/K2 on its
block of windows. ``parallel.mesh.shard_params_tp`` sets each attention's
and MLP's ``tp`` group: their column-parallel layers (qkv, ``cpb_mlp.0``,
fc1) hold the rank's share of output features, the row-parallel ones
(proj, fc2) its share of input features, summed over the group; the
replicated per-head parameters are sliced to the rank's heads.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mvuld_tpu_torch.models.dropout import StageRng, dropout, keep_mask
from mvuld_tpu_torch.ops.fused_dense import gelu, mlp_ln
from mvuld_tpu_torch.ops.window_attention import (
    flat_attention, window_attention_flat, window_attention_flat_sharded)
from mvuld_tpu_torch.parallel.collectives import (all_gather_fn, copy_to_fn,
                                                  rank, reduce_from_fn)

LN_EPS = 1e-6   # flax nn.LayerNorm's default epsilon


@dataclasses.dataclass(frozen=True)
class SwinV2Config:
    img_size: int = 448
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 28
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ape: bool = False
    patch_norm: bool = True
    pretrained_window_sizes: Tuple[int, ...] = (0, 0, 0, 0)
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0     # no config key, as in the JAX model
    drop_path_rate: float = 0.2
    dtype: torch.dtype = torch.float32

    @staticmethod
    def from_cfg(cfg) -> "SwinV2Config":
        s = cfg.MODEL.SWINV2
        return SwinV2Config(
            img_size=cfg.DATA.IMG_SIZE, patch_size=s.PATCH_SIZE,
            in_chans=s.IN_CHANS, embed_dim=s.EMBED_DIM, depths=tuple(s.DEPTHS),
            num_heads=tuple(s.NUM_HEADS), window_size=s.WINDOW_SIZE,
            mlp_ratio=s.MLP_RATIO, qkv_bias=s.QKV_BIAS, ape=s.APE, patch_norm=s.PATCH_NORM,
            pretrained_window_sizes=tuple(s.PRETRAINED_WINDOW_SIZES),
            drop_rate=cfg.MODEL.DROP_RATE,
            drop_path_rate=cfg.MODEL.DROP_PATH_RATE,
            dtype=compute_dtype(cfg.PARALLEL.DTYPE),
        )

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


# --------------------------------------------------------------------------- #
# static (host-side) geometry helpers
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def relative_coords_table(window_size: int, pretrained_window_size: int = 0
                          ) -> np.ndarray:
    """Log-spaced continuous relative coordinates, [(2W-1)², 2] — the CPB
    MLP's input (reference: swin_transformer_v2.py:96-115)."""
    ws = window_size
    h = np.arange(-(ws - 1), ws, dtype=np.float64)
    w = np.arange(-(ws - 1), ws, dtype=np.float64)
    table = np.stack(np.meshgrid(h, w, indexing="ij"), axis=-1)  # [2W-1,2W-1,2]
    denom = (pretrained_window_size - 1) if pretrained_window_size > 0 else (ws - 1)
    denom = max(denom, 1)
    table = table / denom
    table = table * 8
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8)
    return table.reshape(-1, 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: int) -> np.ndarray:
    """[W², W²] index into the (2W-1)² bias table (reference: :117-127)."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords = coords.reshape(2, -1)                      # [2, W²]
    rel = coords[:, :, None] - coords[:, None, :]       # [2, W², W²]
    rel = rel.transpose(1, 2, 0)                        # [W², W², 2]
    rel = rel + (ws - 1)
    idx = rel[..., 0] * (2 * ws - 1) + rel[..., 1]
    return idx.astype(np.int32)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(H: int, W: int, window: int, shift: int) -> Optional[np.ndarray]:
    """Additive attention mask [nW, W², W²] for shifted windows
    (reference: :233-252). None when shift == 0."""
    if shift == 0:
        return None
    img_mask = np.zeros((H, W), np.int32)
    cnt = 0
    for h_sl in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w_sl in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[h_sl, w_sl] = cnt
            cnt += 1
    mask = img_mask.reshape(H // window, window, W // window, window)
    mask = mask.transpose(0, 2, 1, 3).reshape(-1, window * window)
    attn_mask = mask[:, None, :] - mask[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] → [B·nW, window², C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, C)


def window_reverse(x: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    B = x.shape[0] // ((H // window) * (W // window))
    C = x.shape[-1]
    x = x.reshape(B, H // window, W // window, window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def compute_dtype(name: str) -> torch.dtype:
    """PARALLEL.DTYPE → the activations' dtype: bf16, fp32, or (the
    port's card-vs-CPU checks) fp64."""
    return {"bfloat16": torch.bfloat16,
            "float64": torch.float64}.get(name, torch.float32)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of statistics, logits and softmax: fp32, or fp64 for an
    fp64 model."""
    return torch.promote_types(dtype, torch.float32)


def linear(x, layer: nn.Linear, dtype):
    """flax ``nn.Dense(dtype=...)``: input, weight and bias in ``dtype``."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


def layer_norm(x, ln: nn.LayerNorm, dtype):
    """flax ``nn.LayerNorm(dtype=...)``: fp32 statistics, ``dtype`` out."""
    acc = acc_dtype(dtype)
    return F.layer_norm(x.to(acc), ln.normalized_shape, ln.weight.to(acc),
                        ln.bias.to(acc), ln.eps).to(dtype)


# --------------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------------- #

class MlpBlock(nn.Module):
    """fc1 → exact GELU → dropout → fc2 → dropout (reference Mlp; JAX
    MlpBlock); the dropouts only with ``gen`` and ``drop`` > 0."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, out)
        self.drop = drop
        self.tp = None          # the tensor-parallel group

    def forward(self, x, dtype, gen: Optional[torch.Generator] = None):
        x = copy_to_fn(x, self.tp)
        x = dropout(gelu(linear(x, self.fc1, dtype)), self.drop, gen)
        if self.tp is None:
            y = linear(x, self.fc2, dtype)
        else:                   # fc2 row-parallel: partial sums, then bias
            y = (reduce_from_fn(F.linear(x.to(dtype),
                                         self.fc2.weight.to(dtype)), self.tp)
                 + self.fc2.bias.to(dtype))
        return dropout(y, self.drop, gen)


class WindowAttentionV2(nn.Module):
    """SwinV2 cosine window attention with log-CPB continuous bias
    (reference: swin_transformer_v2.py WindowAttention:60-196)."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, pretrained_window_size: int = 0,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.pretrained_window_size = pretrained_window_size
        # attention dropout leaves the kernel (JAX: use_pallas and
        # attn_drop == 0); dropout on the projection does not
        self.dtype, self.use_pallas = dtype, use_pallas and attn_drop == 0.0
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512, bias=True),
                                     nn.ReLU(inplace=True),
                                     nn.Linear(512, num_heads, bias=False))
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = nn.Linear(dim, dim)
        self.sp = self.tp = None    # sequence- / tensor-parallel groups
        self.register_buffer(
            "relative_coords_table",
            torch.as_tensor(relative_coords_table(window_size,
                                                  pretrained_window_size)),
            persistent=False)
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(relative_position_index(window_size),
                            dtype=torch.long).reshape(-1),
            persistent=False)

    def relative_bias(self) -> torch.Tensor:
        """[H, N, N] fp32: 16·sigmoid(cpb[relative_position_index]). The
        gather runs on the compute-dtype table, as the JAX expansion does."""
        N = self.window_size ** 2
        h = F.relu(self.cpb_mlp[0](self.relative_coords_table))
        if self.tp is not None:         # cpb_fc1 column-parallel
            h = all_gather_fn(h.t(), self.tp).t()
        cpb = self.cpb_mlp[2](h)                              # [(2W-1)², H]
        bias = cpb.to(self.dtype)[self.relative_position_index]
        bias = bias.reshape(N, N, -1).permute(2, 0, 1)
        return 16.0 * torch.sigmoid(bias.to(acc_dtype(self.dtype)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                shift: int = 0, store: Optional[dict] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, Hp, Wp, C] feature map (already shifted when applicable);
        returns the same layout. The kernel path derives the shift mask
        from ``shift``; the plain path adds ``mask``. ``store`` (kernel
        path, checkpointed stages) keeps K1's (out, r) — r None under the
        v1 backward — between the first forward and its recomputation.
        ``gen``: the dropout masks' generator (training), or None."""
        B, Hp, Wp, _ = x.shape
        ws, dt = self.window_size, self.dtype
        hd = self.dim // self.num_heads
        H = self.qkv.weight.shape[0] // (3 * hd)     # this rank's heads
        C = H * hd
        N = ws * ws
        x_ = copy_to_fn(x.to(dt), self.tp)
        qkv_b = None
        if self.q_bias is not None:
            qkv_b = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                               self.v_bias]).to(dt)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        bias = self.relative_bias()
        if self.tp is not None:         # the replicated per-head parameters
            lo = rank(self.tp) * H
            if qkv_b is not None:
                qkv_b = copy_to_fn(qkv_b, self.tp).reshape(3, -1)[
                    :, lo * hd:(lo + H) * hd].reshape(-1)
            scale = copy_to_fn(scale, self.tp)[lo:lo + H]
            bias = copy_to_fn(bias, self.tp)[lo:lo + H]

        if self.use_pallas:
            xw = window_partition(x_, ws)
            qkv = F.linear(xw, self.qkv.weight.to(dt), qkv_b)   # [Bn, N, 3C]
            args = (qkv, bias, scale.reshape(H), shift, Hp // ws, Wp // ws)
            if self.sp is not None:
                prev = None if store is None else store.get(self)
                out, r = window_attention_flat_sharded(*args, self.sp,
                                                       saved=prev)
                if store is not None and prev is None:
                    store[self] = (out.detach(), r)
            elif torch.is_grad_enabled():
                prev = None if store is None else store.get(self)
                out, r = flat_attention(*args, saved=prev)
                if store is not None and prev is None:
                    store[self] = (out.detach(), r)
            else:
                out = window_attention_flat(*args)
            out = window_reverse(out.to(dt), ws, Hp, Wp)
        else:
            qkv = F.linear(x_, self.qkv.weight.to(dt), qkv_b)   # [B,Hp,Wp,3C]
            qkvw = window_partition(qkv, ws)
            Bn = qkvw.shape[0]
            qkvw = qkvw.reshape(Bn, N, 3, H, hd).permute(2, 0, 3, 1, 4)
            q, k, v = qkvw[0], qkvw[1], qkvw[2]             # [Bn, H, N, hd]
            acc = acc_dtype(dt)
            q = q / torch.clamp(torch.linalg.vector_norm(
                q.to(acc), dim=-1, keepdim=True), min=1e-12).to(dt)
            k = k / torch.clamp(torch.linalg.vector_norm(
                k.to(acc), dim=-1, keepdim=True), min=1e-12).to(dt)
            attn = (q @ k.transpose(-1, -2)).to(acc)
            attn = attn * scale + bias[None]
            if mask is not None:
                nW = mask.shape[0]
                attn = attn.reshape(Bn // nW, nW, H, N, N) + mask[None, :, None]
                attn = attn.reshape(Bn, H, N, N)
            attn = dropout(torch.softmax(attn, dim=-1), self.attn_drop, gen)
            out = attn.to(dt) @ v
            out = out.permute(0, 2, 1, 3).reshape(Bn, N, C)
            out = window_reverse(out, ws, Hp, Wp)
        if self.tp is None:
            y = linear(out, self.proj, dt)
        else:                   # proj row-parallel: partial sums, then bias
            y = (reduce_from_fn(F.linear(out.to(dt), self.proj.weight.to(dt)),
                                self.tp) + self.proj.bias.to(dt))
        return dropout(y, self.proj_drop, gen)


class SwinBlockV2(nn.Module):
    """Post-norm shifted-window block (reference: :198-330): residuals add
    the NORMALIZED branch outputs (norm after attn/mlp — the V2 change).

    The JAX package's ``window_resident`` option keeps activations in window
    layout between blocks on the TPU; it gives the same numbers, and the
    port always runs this spatial path."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 pretrained_window_size: int = 0,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 use_pallas_mlp: bool = False, drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        Hr, Wr = input_resolution
        # clamp the window to the resolution (reference: :216-219)
        if min(Hr, Wr) <= window_size:
            window_size, shift_size = min(Hr, Wr), 0
        self.input_resolution = input_resolution
        self.window_size, self.shift_size = window_size, shift_size
        # MLP dropout leaves the fused kernel (JAX: use_pallas_mlp and
        # drop == 0)
        self.dtype = dtype
        self.use_pallas_mlp = use_pallas_mlp and drop == 0.0
        self.attn = WindowAttentionV2(dim, window_size, num_heads, qkv_bias,
                                      pretrained_window_size, dtype,
                                      use_pallas, attn_drop, drop)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dim, drop)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        # the plain path's explicit mask; the kernel derives it in-kernel
        mask = (None if self.attn.use_pallas
                else shifted_window_mask(Hr, Wr, window_size, shift_size))
        self.register_buffer(
            "attn_mask", None if mask is None else torch.as_tensor(mask),
            persistent=False)

    def _mlp_half(self, x, gen=None):
        """LN(MLP(x)) — the post-norm second half of the block before its
        residual (reference swin_transformer_v2.py:310-315)."""
        C = x.shape[-1]
        if self.use_pallas_mlp and C <= 512:
            return mlp_ln(x, self.mlp.fc1.weight.t(), self.mlp.fc1.bias,
                          self.mlp.fc2.weight.t(), self.mlp.fc2.bias,
                          self.norm2.weight, self.norm2.bias)
        return layer_norm(self.mlp(x, self.dtype, gen), self.norm2, self.dtype)

    def forward(self, x: torch.Tensor, drop=None,
                store: Optional[dict] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``drop``: (keep-mask of the attention half [B], of the MLP half
        [B], rate) for DropPath, or None. ``gen``: the generator of the
        element-wise dropout masks, or None (no dropout)."""
        Hr, Wr = self.input_resolution
        shift = self.shift_size
        B, L, C = x.shape
        shortcut = x
        x = x.reshape(B, Hr, Wr, C)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        x = self.attn(x, self.attn_mask, shift=shift, store=store, gen=gen)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = layer_norm(x.reshape(B, L, C), self.norm1, self.dtype)
        x = shortcut + drop_path(x, drop, 0)
        return x + drop_path(self._mlp_half(x, gen), drop, 1)


def drop_path(x: torch.Tensor, drop, which: int) -> torch.Tensor:
    """Per-image stochastic depth (the JAX ``DropPath``): images whose mask
    is False are zeroed, the others divided by keep in x's dtype."""
    if drop is None:
        return x
    mask, rate = drop[which], drop[2]
    # made on the device: a host tensor copied there would sync the stream
    keep = torch.full((), 1.0 - rate, dtype=torch.float32,
                      device=x.device).to(x.dtype)
    return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class PatchMerging(nn.Module):
    """2×2 patch concat → Linear 4C→2C → norm (post-norm order, :333-364)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution, self.dtype = input_resolution, dtype
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        Hr, Wr = self.input_resolution
        B, L, C = x.shape
        x = x.reshape(B, Hr // 2, 2, Wr // 2, 2, C)
        # torch order: x0=(0::2,0::2), x1=(1::2,0::2), x2=(0::2,1::2), x3=(1::2,1::2)
        x = x.permute(0, 1, 3, 4, 2, 5)            # [B, H/2, W/2, wcol, hrow, C]
        x = torch.cat([x[:, :, :, 0, 0], x[:, :, :, 0, 1],
                       x[:, :, :, 1, 0], x[:, :, :, 1, 1]], dim=-1)
        x = linear(x.reshape(B, L // 4, 4 * C), self.reduction, self.dtype)
        return layer_norm(x, self.norm, self.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, config: SwinV2Config):
        super().__init__()
        c = config
        self.dtype = c.dtype
        self.proj = nn.Conv2d(c.in_chans, c.embed_dim, c.patch_size,
                              stride=c.patch_size)
        self.norm = nn.LayerNorm(c.embed_dim, eps=LN_EPS) if c.patch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, S, S, in_chans] → [B, (S/p)², embed_dim]."""
        dt = self.dtype
        x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=self.proj.stride)
        x = x.flatten(2).transpose(1, 2)
        if self.norm is not None:
            x = layer_norm(x, self.norm, dt)
        return x


class BasicLayer(nn.Module):
    """One stage: its blocks and the optional downsample (reference
    BasicLayer; the JAX package builds the same tree inline)."""

    def __init__(self, blocks, downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x, drops=None, store: Optional[dict] = None,
                gen: Optional[torch.Generator] = None):
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if drops is None else drops[i], store, gen)
        return x if self.downsample is None else self.downsample(x)


def _replay_stage(layer: BasicLayer, x, drops, store: dict,
                  rng: StageRng):
    """A checkpointed stage with element-wise dropout: the recomputation
    draws the first run's masks through ``rng``."""
    return rng.run(layer, x, drops, store)


class SwinTransformerV2(nn.Module):
    """The image tower: patch embedding, four stages and the final norm,
    returning the mean-pooled embedding [B, num_features] (the JAX model
    with ``return_features=True``, the reference's ``forward_features``).
    With ``num_classes`` > 0 the head's logits [B, num_classes] fp32
    instead. ``window_resident`` is accepted for parity with the JAX
    constructor and changes nothing here (see SwinBlockV2).
    ``remat_stages``: the stage indices checkpointed in training (the JAX
    ``use_checkpoint`` with ``remat_stages``)."""

    def __init__(self, config: SwinV2Config, use_pallas: bool = False,
                 use_pallas_mlp: bool = False, window_resident: bool = False,
                 remat_stages: Tuple[int, ...] = (), num_classes: int = 0):
        super().__init__()
        c = self.config = config
        self.remat_stages = tuple(remat_stages)
        self.patch_embed = PatchEmbed(c)
        res = c.img_size // c.patch_size
        self.absolute_pos_embed = (
            nn.Parameter(torch.zeros(1, res * res, c.embed_dim)) if c.ape
            else None)
        layers = []
        for i, depth in enumerate(c.depths):
            dim = int(c.embed_dim * 2 ** i)
            r = res // 2 ** i
            blocks = [SwinBlockV2(
                dim, (r, r), c.num_heads[i], c.window_size,
                0 if j % 2 == 0 else c.window_size // 2, c.mlp_ratio,
                c.qkv_bias, c.pretrained_window_sizes[i], c.dtype,
                use_pallas, use_pallas_mlp, c.drop_rate, c.attn_drop_rate)
                for j in range(depth)]
            down = (PatchMerging((r, r), dim, c.dtype)
                    if i < len(c.depths) - 1 else None)
            layers.append(BasicLayer(blocks, down))
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(c.num_features, eps=LN_EPS)
        self.head = (nn.Linear(c.num_features, num_classes) if num_classes > 0
                     else None)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None,
                return_features: bool = False) -> torch.Tensor:
        """``train``: DropPath from ``gen`` and checkpointing of
        ``remat_stages``. ``return_features``: the pooled embedding even
        when the model has a head (the frozen featurizer of a fine-tuned
        classifier)."""
        c = self.config
        # the element-wise dropouts' generator: None leaves them out
        egen = (gen if train and (c.drop_rate > 0 or c.attn_drop_rate > 0)
                else None)
        x = self.patch_embed(x.to(c.dtype))
        if self.absolute_pos_embed is not None:
            x = x + self.absolute_pos_embed.to(c.dtype)
        x = dropout(x, c.drop_rate, egen)
        rates = np.linspace(0, c.drop_path_rate, sum(c.depths)).tolist()
        first = 0
        for i, layer in enumerate(self.layers):
            n = len(layer.blocks)
            drops = None
            if train and gen is not None:
                # the whole stage's masks before it runs: a checkpointed
                # stage recomputes with the same masks
                drops = [(keep_mask((x.shape[0],), r, gen, x.device),
                          keep_mask((x.shape[0],), r, gen, x.device), r)
                         if r > 0 else None for r in rates[first:first + n]]
            first += n
            if train and i in self.remat_stages:
                store: dict = {}
                # the stage draws from no generator but ``egen``, so the
                # checkpoint keeps no generator state
                if egen is None:
                    x = torch.utils.checkpoint.checkpoint(
                        layer, x, drops, store, use_reentrant=False,
                        preserve_rng_state=False)
                else:
                    x = torch.utils.checkpoint.checkpoint(
                        _replay_stage, layer, x, drops, store,
                        StageRng(egen), use_reentrant=False,
                        preserve_rng_state=False)
            else:
                x = layer(x, drops, None, egen)
        x = layer_norm(x, self.norm, c.dtype).mean(dim=1)
        x = x.to(acc_dtype(c.dtype))
        return x if self.head is None or return_features else self.head(x)


def sequence_parallel(model: nn.Module, group) -> nn.Module:
    """Run every kernel-path window attention of ``model`` sequence-parallel
    over ``group`` (``window_attention_flat_sharded``; the JAX
    ``PallasOpts(sp_mesh, sp_axis)``). Every rank runs the model alike on
    the whole batch; the batch must divide into the group's blocks."""
    for m in model.modules():
        if isinstance(m, WindowAttentionV2):
            m.sp = group
    return model
