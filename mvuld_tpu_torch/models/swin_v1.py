"""Swin Transformer V1 in PyTorch — classic pre-norm Swin with a discrete
relative-position bias table.

Counterpart of ``mvuld_tpu/models/swin_v1.py`` (reference
mvuld/models/swin_transformer.py:458-585). Differences from V2
(``models/swin_v2.py``):

  * pre-norm blocks (norm before attention and MLP; the residual adds the
    raw branch output);
  * scaled dot-product attention: q is multiplied by ``qk_scale`` (else
    hd^-½) before q·kᵀ, the logits are fp32, the bias is added, then the
    shift mask, then the softmax;
  * a learned ``relative_position_bias_table`` [(2W-1)², H] gathered by the
    static position index (the table the reference's checkpoint surgery
    resamples across window sizes, ``models/swin_convert.py``);
  * one fused qkv bias;
  * PatchMerging applies its norm BEFORE the reduction.

Module and parameter names are the reference torch ones
(``layers.{i}.blocks.{j}.attn.relative_position_bias_table``,
``layers.{i}.downsample.reduction`` …), so a reference checkpoint loads by
key and ``models/convert.py`` maps the JAX variables one to one.

Activations run in ``config.dtype`` with fp32 parameters, as in the JAX
model and the port's SwinV2: dense layers compute in the dtype, LayerNorm
takes fp32 statistics, the head is fp32. No kernel: the JAX model runs
plain XLA (no ``pallas_call``), and so does this one.

Training (``forward(x, train=True, gen=...)``): MODEL.DROP_RATE drops out
the patch embedding, the MLP after GELU and fc2, and the projection,
``attn_drop_rate`` the attention probabilities, and DropPath drops whole
images with the per-block rates ``linspace(0, drop_path_rate, Σdepths)``;
every mask comes from ``gen``. ``SwinBlockV1``'s ``mlp_layer`` swaps the
FFN (the MoE variant, ``models/swin_variants.py``); a layer that returns
``(y, aux)`` makes the block return ``(x, aux)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mvuld_tpu_torch.models import swin_v2
from mvuld_tpu_torch.models.dropout import dropout, keep_mask
from mvuld_tpu_torch.models.swin_v2 import (LN_EPS, MlpBlock, PatchEmbed,
                                            SwinV2Config, acc_dtype,
                                            compute_dtype, layer_norm, linear,
                                            relative_position_index,
                                            shifted_window_mask,
                                            window_partition, window_reverse)


@dataclasses.dataclass(frozen=True)
class SwinV1Config(SwinV2Config):
    num_classes: int = 2
    qk_scale: Optional[float] = None

    @staticmethod
    def from_cfg(cfg) -> "SwinV1Config":
        s = cfg.MODEL.SWIN
        return SwinV1Config(
            img_size=cfg.DATA.IMG_SIZE, patch_size=s.PATCH_SIZE,
            in_chans=s.IN_CHANS, num_classes=cfg.MODEL.NUM_CLASSES,
            embed_dim=s.EMBED_DIM, depths=tuple(s.DEPTHS),
            num_heads=tuple(s.NUM_HEADS), window_size=s.WINDOW_SIZE,
            mlp_ratio=s.MLP_RATIO, qkv_bias=s.QKV_BIAS, qk_scale=s.QK_SCALE,
            drop_rate=cfg.MODEL.DROP_RATE,
            drop_path_rate=cfg.MODEL.DROP_PATH_RATE,
            ape=s.APE, patch_norm=s.PATCH_NORM,
            pretrained_window_sizes=(0,) * len(s.DEPTHS),
            dtype=compute_dtype(cfg.PARALLEL.DTYPE),
        )


def block_window(resolution: Tuple[int, int], window: int, shift: int
                 ) -> Tuple[int, int]:
    """(window, shift) of a block: a stage whose resolution is ≤ the window
    takes window = resolution and shift 0 (JAX swin_v1.py:117-118)."""
    if min(resolution) <= window:
        return min(resolution), 0
    return window, shift


def drop_path(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]
              ) -> torch.Tensor:
    """Per-image stochastic depth (the JAX ``DropPath``), the mask drawn
    from ``gen``: images dropped are zeroed, the others divided by keep."""
    if gen is None or rate == 0.0:
        return x
    mask = keep_mask((x.shape[0],), rate, gen, x.device)
    return swin_v2.drop_path(x, (mask, None, rate), 0)


class WindowAttentionV1(nn.Module):
    """Scaled window attention with the discrete bias table (reference
    swin_transformer.py WindowAttention)."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size, self.num_heads, self.dtype = (window_size,
                                                        num_heads, dtype)
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(relative_position_index(window_size),
                            dtype=torch.long).reshape(-1),
            persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B·nW, N, C] windows; mask: [nW, N, N] or None."""
        Bn, N, C = x.shape
        H, dt = self.num_heads, self.dtype
        qkv = linear(x, self.qkv, dt).reshape(Bn, N, 3, H, C // H)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        acc = acc_dtype(dt)
        attn = (q @ k.transpose(-1, -2)).to(acc)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(N, N, H).permute(2, 0, 1)[None].to(acc)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(Bn // nW, nW, H, N, N) + mask[None, :, None]
            attn = attn.reshape(Bn, H, N, N)
        attn = dropout(torch.softmax(attn, dim=-1), self.attn_drop, gen)
        out = (attn.to(dt) @ v).permute(0, 2, 1, 3).reshape(Bn, N, C)
        return dropout(linear(out, self.proj, dt), self.proj_drop, gen)


class SwinBlockV1(nn.Module):
    """Pre-norm shifted-window block. ``mlp_layer(hidden, out, drop)``
    builds the FFN in place of ``MlpBlock`` (the MoE variant); its forward
    takes (y, dtype, gen) and may return (y, aux). ``fc2_bias`` False:
    ``MlpBlock``'s fc2 without a bias (Swin-MoE's MLP_FC2_BIAS)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 mlp_layer: Optional[Callable[[int, int, float],
                                              nn.Module]] = None,
                 fc2_bias: bool = True):
        super().__init__()
        self.input_resolution, self.dtype = input_resolution, dtype
        self.window_size, self.shift_size = block_window(
            input_resolution, window_size, shift_size)
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttentionV1(dim, self.window_size, num_heads,
                                      qkv_bias, qk_scale, attn_drop, drop,
                                      dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        hidden = int(dim * mlp_ratio)
        self.mlp = (MlpBlock(dim, hidden, dim, drop) if mlp_layer is None
                    else mlp_layer(hidden, dim, drop))
        if mlp_layer is None and not fc2_bias:
            self.mlp.fc2 = nn.Linear(hidden, dim, bias=False)
        mask = shifted_window_mask(*input_resolution, self.window_size,
                                   self.shift_size)
        self.register_buffer(
            "attn_mask", None if mask is None else torch.as_tensor(mask),
            persistent=False)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None):
        """``gen``: the training step's generator (dropout, DropPath, the
        MoE's gate noise), or None in evaluation."""
        Hr, Wr = self.input_resolution
        ws, shift = self.window_size, self.shift_size
        B, L, C = x.shape
        shortcut = x
        x = layer_norm(x, self.norm1, self.dtype).reshape(B, Hr, Wr, C)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        x = self.attn(window_partition(x, ws), self.attn_mask, gen)
        x = window_reverse(x, ws, Hr, Wr)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + drop_path(x.reshape(B, L, C), self.drop_path, gen)
        y = self.mlp(layer_norm(x, self.norm2, self.dtype), self.dtype, gen)
        aux = None
        if isinstance(y, tuple):
            y, aux = y
        x = x + drop_path(y, self.drop_path, gen)
        return x if aux is None else (x, aux)


class PatchMergingV1(nn.Module):
    """2×2 patch concat → norm → Linear 4C→2C without bias (V1 order)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution, self.dtype = input_resolution, dtype
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        Hr, Wr = self.input_resolution
        B, L, C = x.shape
        x = x.reshape(B, Hr // 2, 2, Wr // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        x = torch.cat([x[:, :, :, 0, 0], x[:, :, :, 0, 1],
                       x[:, :, :, 1, 0], x[:, :, :, 1, 1]], dim=-1)
        x = layer_norm(x.reshape(B, L // 4, 4 * C), self.norm, self.dtype)
        return linear(x, self.reduction, self.dtype)


class BasicLayerV1(nn.Module):
    """One stage: its blocks and the optional downsample. Blocks that
    return (x, aux) add their aux to the stage's."""

    def __init__(self, blocks, downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x, gen=None):
        aux = None
        for blk in self.blocks:
            x = blk(x, gen)
            if isinstance(x, tuple):
                x, a = x
                aux = a if aux is None else aux + a
        if self.downsample is not None:
            x = self.downsample(x)
        return x, aux


class SwinBackboneV1(nn.Module):
    """Patch embedding, the stages of ``make_block`` blocks with V1 patch
    merging, the final norm and the head: the skeleton SwinV1, Swin-MoE
    and Swin-MLP share (JAX builds the same tree inline in each model).
    ``make_block(dim, resolution, heads, shift, drop_path, stage, block)``
    returns one block."""

    def __init__(self, config: SwinV1Config, make_block, ape: bool):
        super().__init__()
        c = self.config = config
        self.patch_embed = PatchEmbed(c)
        res = c.img_size // c.patch_size
        self.absolute_pos_embed = (
            nn.Parameter(torch.zeros(1, res * res, c.embed_dim)) if ape
            else None)
        rates = np.linspace(0, c.drop_path_rate, sum(c.depths)).tolist()
        layers, first = [], 0
        for i, depth in enumerate(c.depths):
            dim = int(c.embed_dim * 2 ** i)
            r = res // 2 ** i
            blocks = [make_block(dim, (r, r), c.num_heads[i],
                                 0 if j % 2 == 0 else c.window_size // 2,
                                 float(rates[first + j]), i, j)
                      for j in range(depth)]
            first += depth
            down = (PatchMergingV1((r, r), dim, c.dtype)
                    if i < len(c.depths) - 1 else None)
            layers.append(BasicLayerV1(blocks, down))
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(c.num_features, eps=LN_EPS)
        self.head = nn.Linear(c.num_features, c.num_classes)

    def features(self, x: torch.Tensor, train: bool = False,
                 gen: Optional[torch.Generator] = None):
        """(pooled fp32 features [B, num_features], the blocks' summed aux
        or None)."""
        c = self.config
        gen = gen if train else None
        x = self.patch_embed(x.to(c.dtype))
        if self.absolute_pos_embed is not None:
            x = x + self.absolute_pos_embed.to(c.dtype)
        x = dropout(x, c.drop_rate, gen)
        aux = None
        for layer in self.layers:
            x, a = layer(x, gen)
            if a is not None:
                aux = a if aux is None else aux + a
        x = layer_norm(x, self.norm, c.dtype).mean(dim=1)
        x = x.to(acc_dtype(c.dtype))
        return x, aux


class SwinTransformerV1(SwinBackboneV1):
    """SwinV1 (JAX ``SwinTransformerV1``): logits [B, num_classes] fp32,
    or with ``return_features`` the pooled embedding."""

    def __init__(self, config: SwinV1Config):
        c = config

        def block(dim, res, heads, shift, dp, i, j):
            return SwinBlockV1(dim, res, heads, c.window_size, shift,
                               c.mlp_ratio, c.qkv_bias, c.qk_scale,
                               c.drop_rate, c.attn_drop_rate, dp, c.dtype)

        super().__init__(config, block, ape=c.ape)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None,
                return_features: bool = False) -> torch.Tensor:
        feats, _ = self.features(x, train, gen)
        return feats if return_features else self.head(feats)
