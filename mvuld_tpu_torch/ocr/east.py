"""EAST text detector in PyTorch — the OCR subsystem's model and loss.

Counterpart of ``mvuld_tpu/ocr/east.py`` (reference OCR/model.py:8-177): a
half-channel VGG16-BN feature extractor (cfg [32,32,M,64,64,M,128,128,128,M,
256,256,256,M,256,256,256,M]), a U-Net-style merge decoder over the /32,
/16, /8, /4 feature maps, and heads giving a sigmoid score map (1 channel)
and a geo map (4 sigmoid·scope distances + (sigmoid − 0.5)·π angle) at 1/4
input scale. Module names are the Flax ones (``extractor.conv_{i}``,
``extractor.bn_{i}``, ``merge.conv_{1..7}``, ``merge.bn_{1..7}``,
``score_head``, ``loc_head``, ``angle_head``), so ``models/convert.py``
maps the JAX variables onto them one to one.

Layout NCHW: the model takes [B, 3, H, W] and returns score [B, 1, H/4,
W/4] and geo [B, 5, H/4, W/4] in the weights' type (fp32; fp64 in the
card-against-CPU check of ``chip_smoke.py``); ``east_loss`` takes the maps
in that layout (the JAX loss is channel-last; ``to_nchw`` converts the
rasterized gt at the boundary).

As in JAX: BatchNorm is flax's (``models/graph_nets.batch_norm``: batch
statistics with the biased variance in training, running statistics
updated with momentum 0.99; the running statistics in eval), and the 2×
upsampling is ``jax.image.resize(..., "bilinear")``, which at 2× is
``F.interpolate(scale_factor=2, mode="bilinear", align_corners=False)``
(not the reference torch code's ``align_corners=True``). The convolutions
are ``F.conv2d`` (cuDNN on the card). Started on its own, ``train_east``
leaves PyTorch's defaults: cuDNN may then take TF32 for these fp32
convolutions. ``chip_smoke.py`` turns TF32 off for its whole run, and its
card-against-CPU tolerance holds under that setting.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvuld_tpu_torch.models.graph_nets import batch_norm

VGG_CFG: Sequence = (32, 32, "M", 64, 64, "M", 128, 128, 128, "M",
                     256, 256, 256, "M", 256, 256, 256, "M")
BN_EPS = 1e-5   # flax nn.BatchNorm's default epsilon


def _cbr(x, conv: nn.Conv2d, bn: nn.BatchNorm2d, train: bool):
    return F.relu(batch_norm(conv(x), bn, train))


class VGGExtractor(nn.Module):
    """Half-channel VGG16-BN; returns the post-pool features at /4, /8,
    /16, /32 (reference: the extractor's features after pools 2..5)."""

    def __init__(self, in_chans: int = 3):
        super().__init__()
        c = in_chans
        i = 0
        for v in VGG_CFG:
            if v == "M":
                continue
            self.add_module(f"conv_{i}", nn.Conv2d(c, v, 3, padding=1))
            self.add_module(f"bn_{i}", nn.BatchNorm2d(v, eps=BN_EPS))
            c, i = v, i + 1

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> List[torch.Tensor]:
        feats = []
        conv_i = pool_i = 0
        for v in VGG_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                pool_i += 1
                if pool_i >= 2:          # pools 2..5 → /4../32
                    feats.append(x)
            else:
                x = _cbr(x, getattr(self, f"conv_{conv_i}"),
                         getattr(self, f"bn_{conv_i}"), train)
                conv_i += 1
        return feats                      # [/4, /8, /16, /32]


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(x, 2×, "bilinear")`` on an NCHW map."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class MergeDecoder(nn.Module):
    """U-Net merge (reference: OCR/model.py:80-136): upsample, concatenate
    [upsampled, skip], 1×1 then 3×3 conv-bn-relu, three times; a final
    3×3."""

    # (name, in channels, out channels, kernel)
    LAYERS = (("1", 256 + 256, 128, 1), ("2", 128, 128, 3),
              ("3", 128 + 128, 64, 1), ("4", 64, 64, 3),
              ("5", 64 + 64, 32, 1), ("6", 32, 32, 3), ("7", 32, 32, 3))

    def __init__(self):
        super().__init__()
        for name, cin, cout, k in self.LAYERS:
            self.add_module(f"conv_{name}",
                            nn.Conv2d(cin, cout, k, padding=k // 2))
            self.add_module(f"bn_{name}", nn.BatchNorm2d(cout, eps=BN_EPS))

    def _cbr(self, x, name: str, train: bool):
        return _cbr(x, getattr(self, f"conv_{name}"),
                    getattr(self, f"bn_{name}"), train)

    def forward(self, feats, train: bool = False) -> torch.Tensor:
        f4, f8, f16, f32 = feats
        y = torch.cat([upsample2x(f32), f16], dim=1)
        y = self._cbr(self._cbr(y, "1", train), "2", train)
        y = torch.cat([upsample2x(y), f8], dim=1)
        y = self._cbr(self._cbr(y, "3", train), "4", train)
        y = torch.cat([upsample2x(y), f4], dim=1)
        y = self._cbr(self._cbr(y, "5", train), "6", train)
        return self._cbr(y, "7", train)


class EAST(nn.Module):
    """Full detector: x [B, 3, H, W] → (score [B, 1, H/4, W/4],
    geo [B, 5, H/4, W/4]). ``train`` takes BatchNorm's batch
    statistics and updates its running statistics."""

    def __init__(self, geo_scope: float = 512.0):
        super().__init__()
        self.geo_scope = geo_scope
        self.extractor = VGGExtractor()
        self.merge = MergeDecoder()
        self.score_head = nn.Conv2d(32, 1, 1)
        self.loc_head = nn.Conv2d(32, 4, 1)
        self.angle_head = nn.Conv2d(32, 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y = self.merge(self.extractor(x, train), train)
        score = torch.sigmoid(self.score_head(y))
        loc = torch.sigmoid(self.loc_head(y)) * self.geo_scope
        angle = (torch.sigmoid(self.angle_head(y)) - 0.5) * math.pi
        return score, torch.cat([loc, angle], dim=1)


def to_nchw(a) -> torch.Tensor:
    """A channel-last array [B, H, W, C] (numpy or tensor) as NCHW."""
    return torch.as_tensor(a).permute(0, 3, 1, 2)


def dice_loss(gt_score: torch.Tensor, pred_score: torch.Tensor
              ) -> torch.Tensor:
    inter = torch.sum(gt_score * pred_score)
    union = torch.sum(gt_score) + torch.sum(pred_score) + 1e-5
    return 1.0 - 2.0 * inter / union


def east_loss(gt_score: torch.Tensor, pred_score: torch.Tensor,
              gt_geo: torch.Tensor, pred_geo: torch.Tensor,
              ignored_map: torch.Tensor, weight_angle: float = 10.0
              ) -> torch.Tensor:
    """Reference: OCR/loss.py Loss.forward:34-47, NCHW maps (score and
    ignored [B, 1, h, w], geo [B, 5, h, w]). An image batch without a
    positive pixel gives 0."""
    n_pos = torch.sum(gt_score)
    classify = dice_loss(gt_score, pred_score * (1.0 - ignored_map))
    d1g, d2g, d3g, d4g, ag = torch.split(gt_geo, 1, dim=1)
    d1p, d2p, d3p, d4p, ap = torch.split(pred_geo, 1, dim=1)
    area_gt = (d1g + d2g) * (d3g + d4g)
    area_pred = (d1p + d2p) * (d3p + d4p)
    w_union = torch.minimum(d3g, d3p) + torch.minimum(d4g, d4p)
    h_union = torch.minimum(d1g, d1p) + torch.minimum(d2g, d2p)
    area_inter = w_union * h_union
    area_union = area_gt + area_pred - area_inter
    iou_map = -torch.log((area_inter + 1.0) / (area_union + 1.0))
    angle_map = 1.0 - torch.cos(ap - ag)
    denom = torch.clamp(n_pos, min=1.0)
    angle_loss = torch.sum(angle_map * gt_score) / denom
    iou_loss = torch.sum(iou_map * gt_score) / denom
    total = weight_angle * angle_loss + iou_loss + classify
    # no-target images contribute zero (reference: loss.py:36-38)
    return torch.where(n_pos < 1.0, torch.zeros_like(total), total)
