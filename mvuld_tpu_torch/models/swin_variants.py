"""Swin-MoE and Swin-MLP, and ``build_model`` over the image backbones,
in PyTorch.

Counterpart of ``mvuld_tpu/models/swin_variants.py``:

  * ``SwinTransformerMoE`` (reference mvuld/models/swin_transformer_moe.py
    :43-824): SwinV1 blocks whose FFN is a top-k ``MoEFFN`` in the blocks
    MODEL.SWIN_MOE.MOE_BLOCKS names per stage ([-1]: none); no absolute
    position embedding; returns (logits or features, the summed aux loss);
  * ``SwinMLP`` (reference mvuld/models/swin_mlp.py): the attention
    replaced by a spatial MLP over each window's tokens, one bias-free
    [w², w²] weight per head (``spatial_mlp`` [H, w², w²]), on the map
    rolled for the shift, as the JAX block does;
  * ``build_model(cfg)``: MODEL.TYPE ∈ {swinv2 (alias swin2), swin,
    swin_moe, swin_mlp} through the port's ``MODELS`` registry (reference
    mvuld/models/build.py:14-106).

``build_model`` for ``swinv2`` gives the port's ``SwinTransformerV2`` with
its head, every stage checkpointed in training under TRAIN.USE_CHECKPOINT
(JAX ``build_model``'s ``use_checkpoint``, remat_stages None); ``kernels=True``
runs its attention through K1 (K2 or K5 backward) and, with
TRAIN.FUSED_MLP, its MLP halves through K3/K3b, as ``train_swin`` does on
the card. The other three types have no kernel (no ``pallas_call`` in
their JAX modules either).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mvuld_tpu_torch.core.registry import MODELS
from mvuld_tpu_torch.models.moe import MoEFFN, make_moe_mlp_layer
from mvuld_tpu_torch.models.swin_v1 import (SwinBackboneV1, SwinBlockV1,
                                            SwinTransformerV1, SwinV1Config,
                                            block_window, drop_path)
from mvuld_tpu_torch.models.swin_v2 import (LN_EPS, MlpBlock,
                                            SwinTransformerV2, SwinV2Config,
                                            layer_norm, window_partition,
                                            window_reverse)


class SwinTransformerMoE(SwinBackboneV1):
    """SwinV1 backbone with a ``MoEFFN`` in the blocks of ``moe_blocks``
    (one tuple of block indices per stage); forward returns
    (logits or features, aux) with aux the sum over the MoE blocks.
    ``bpr``, ``gshard_loss``, ``fc2_bias`` (the experts' and the dense
    blocks' fc2) and ``moe_drop`` (the experts' dropout) as
    ``models/moe.MoEFFN`` takes them."""

    def __init__(self, config: SwinV1Config,
                 moe_blocks: Sequence[Sequence[int]] = ((-1,),) * 4,
                 num_experts: int = 4, top_k: int = 1,
                 capacity_factor: float = 1.25, gate_noise: float = 1.0,
                 aux_weight: float = 0.01, bpr: bool = False,
                 gshard_loss: bool = True, fc2_bias: bool = True,
                 moe_drop: float = 0.0):
        c = config
        sets = [set(b) for b in moe_blocks]
        moe = make_moe_mlp_layer(num_experts, top_k, capacity_factor,
                                 gate_noise, aux_weight, bpr, gshard_loss,
                                 fc2_bias, moe_drop)

        def block(dim, res, heads, shift, dp, i, j):
            use_moe = i < len(sets) and j in sets[i]
            return SwinBlockV1(dim, res, heads, c.window_size, shift,
                               c.mlp_ratio, c.qkv_bias, c.qk_scale,
                               c.drop_rate, c.attn_drop_rate, dp, c.dtype,
                               mlp_layer=moe if use_moe else None,
                               fc2_bias=fc2_bias)

        super().__init__(config, block, ape=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None,
                return_features: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats, aux = self.features(x, train, gen)
        if aux is None:
            aux = torch.zeros((), dtype=feats.dtype, device=feats.device)
        return (feats if return_features else self.head(feats)), aux

    def moe_layers(self):
        return [m for m in self.modules() if isinstance(m, MoEFFN)]


class SwinMLPBlock(nn.Module):
    """Pre-norm block whose token mixer is the per-head spatial MLP:
    out[b, h, m] = Σ_n spatial_mlp[h, m, n] · x[b, h, n] over each window's
    w² tokens (JAX ``einsum("bhnd,hmn->bhmd")``)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution, self.dtype = input_resolution, dtype
        self.num_heads, self.drop_path = num_heads, drop_path
        self.window_size, self.shift_size = block_window(
            input_resolution, window_size, shift_size)
        n = self.window_size ** 2
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.spatial_mlp = nn.Parameter(torch.zeros(num_heads, n, n))
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dim, drop)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None):
        Hr, Wr = self.input_resolution
        ws, shift, H = self.window_size, self.shift_size, self.num_heads
        B, L, C = x.shape
        shortcut = x
        x = layer_norm(x, self.norm1, self.dtype).reshape(B, Hr, Wr, C)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        xw = window_partition(x, ws)                          # [B·nW, n, C]
        Bn, n, _ = xw.shape
        xw = xw.reshape(Bn, n, H, C // H).permute(0, 2, 1, 3)
        xw = self.spatial_mlp.to(xw.dtype) @ xw               # [B·nW, H, n, d]
        xw = xw.permute(0, 2, 1, 3).reshape(Bn, n, C)
        x = window_reverse(xw, ws, Hr, Wr)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + drop_path(x.reshape(B, L, C), self.drop_path, gen)
        y = self.mlp(layer_norm(x, self.norm2, self.dtype), self.dtype, gen)
        return x + drop_path(y, self.drop_path, gen)


class SwinMLP(SwinBackboneV1):
    """Swin-MLP (JAX ``SwinMLP``): logits, or the pooled features."""

    def __init__(self, config: SwinV1Config):
        c = config

        def block(dim, res, heads, shift, dp, i, j):
            return SwinMLPBlock(dim, res, heads, c.window_size, shift,
                                c.mlp_ratio, c.drop_rate, dp, c.dtype)

        super().__init__(config, block, ape=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None,
                return_features: bool = False) -> torch.Tensor:
        feats, _ = self.features(x, train, gen)
        return feats if return_features else self.head(feats)


# --------------------------------------------------------------------------- #
# build_model (reference: mvuld/models/build.py build_model:14-106)
# --------------------------------------------------------------------------- #

@MODELS.register("swinv2")
def _build_swinv2(cfg, kernels: bool = False, **kw):
    sc = SwinV2Config.from_cfg(cfg)
    remat = (tuple(range(len(sc.depths))) if cfg.TRAIN.USE_CHECKPOINT
             else ())
    return SwinTransformerV2(
        sc, use_pallas=kernels,
        use_pallas_mlp=kernels and cfg.TRAIN.FUSED_MLP, remat_stages=remat,
        num_classes=cfg.MODEL.NUM_CLASSES, **kw)


@MODELS.register("swin")
def _build_swin(cfg, **kw):
    return SwinTransformerV1(SwinV1Config.from_cfg(cfg), **kw)


@MODELS.register("swin_moe")
def _build_swin_moe(cfg, **kw):
    m = cfg.MODEL.SWIN_MOE
    base = dataclasses.replace(
        SwinV1Config.from_cfg(cfg), embed_dim=m.EMBED_DIM,
        depths=tuple(m.DEPTHS), num_heads=tuple(m.NUM_HEADS),
        window_size=m.WINDOW_SIZE, mlp_ratio=m.MLP_RATIO,
        qkv_bias=m.QKV_BIAS, qk_scale=m.QK_SCALE, ape=m.APE,
        patch_norm=m.PATCH_NORM)
    return SwinTransformerMoE(
        base, moe_blocks=tuple(tuple(b) for b in m.MOE_BLOCKS),
        num_experts=max(m.NUM_LOCAL_EXPERTS, 1), top_k=m.TOP_VALUE,
        capacity_factor=m.CAPACITY_FACTOR, gate_noise=m.GATE_NOISE,
        aux_weight=m.AUX_LOSS_WEIGHT, bpr=m.USE_BPR,
        gshard_loss=m.IS_GSHARD_LOSS, fc2_bias=m.MLP_FC2_BIAS,
        moe_drop=m.MOE_DROP, **kw)


@MODELS.register("swin_mlp")
def _build_swin_mlp(cfg, **kw):
    m = cfg.MODEL.SWIN_MLP
    base = dataclasses.replace(
        SwinV1Config.from_cfg(cfg), embed_dim=m.EMBED_DIM,
        depths=tuple(m.DEPTHS), num_heads=tuple(m.NUM_HEADS),
        window_size=m.WINDOW_SIZE, mlp_ratio=m.MLP_RATIO, ape=m.APE,
        patch_norm=m.PATCH_NORM)
    return SwinMLP(base, **kw)


def build_model(cfg, **kw) -> nn.Module:
    """The image backbone MODEL.TYPE names ('swin2' is the reference's
    alias of 'swinv2'); ``kw`` goes to the type's build function
    (``kernels`` for swinv2). An unknown type raises the registry's
    KeyError."""
    mtype = cfg.MODEL.TYPE
    if mtype == "swin2":
        mtype = "swinv2"
    return MODELS.build(mtype, cfg, **kw)
