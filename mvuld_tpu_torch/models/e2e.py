"""End-to-end tri-modal model in PyTorch: UniXcoder (function + per-line),
SwinV2 (rendered image) and the fusion head in one forward.

Counterpart of ``mvuld_tpu/models/e2e.py``: serving, and training with
``train=True`` (DropPath, dropout and BatchNorm statistics; gradients flow
through the packed gather and scatter of the line embeddings).

Inputs:
  func_ids  [B, T]        whole-function token ids
  node_ids  [B, N, Tn]    per-line token ids
  image     [B, S, S, 3]  rendered graph (normalized, NHWC)
  pos       [B, N, P], adj [B, N, N] bool, node_mask [B, N]
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mvuld_tpu_torch.models.dropout import SlotRows
from mvuld_tpu_torch.models.fusion_zoo import MultiDefectAblation
from mvuld_tpu_torch.models.roberta import (RobertaConfig, RobertaEncoder,
                                            masked_mean)
from mvuld_tpu_torch.models.swin_v2 import SwinTransformerV2, SwinV2Config


class EndToEndMVulD(nn.Module):
    """``node_capacity``: packed-batch size for the per-line encoder. Valid
    lines (node_mask > 0) are stable-sorted to the front — original order
    preserved — into a [node_capacity, Tn] batch, encoded once, and
    scattered back to [B, N, H]. Lines beyond capacity get a zero embedding.
    ``None`` encodes every slot (the parity reference path), unless the
    forward is given ``line_rows``: the capacity of that call alone, which
    the serving loop counts from each chunk's mask. A packed
    line's dropout masks are its slot's rows of masks drawn over all B·N
    slots (``models/dropout.SlotRows``), as an unpacked run draws them, so
    they do not depend on the line's place in the pack (one rank and dp
    ranks pack differently)."""

    def __init__(self, text_config: RobertaConfig, swin_config: SwinV2Config,
                 hidden: int = 512, num_classes: int = 2, num_rs_gcn: int = 8,
                 num_hidden: int = 8, max_nodes: int = 100, pos_dim: int = 4,
                 use_pallas: bool = False, use_pallas_mlp: bool = False,
                 window_resident: bool = False,
                 node_capacity: Optional[int] = None,
                 swin_remat_stages: tuple = (), text_remat: bool = False):
        super().__init__()
        self.text_config, self.swin_config = text_config, swin_config
        self.node_capacity = node_capacity
        self.text_encoder = RobertaEncoder(text_config, remat=text_remat)
        self.swin = SwinTransformerV2(swin_config, use_pallas=use_pallas,
                                      use_pallas_mlp=use_pallas_mlp,
                                      window_resident=window_resident,
                                      remat_stages=swin_remat_stages)
        self.fusion = MultiDefectAblation(
            num_classes=num_classes, hidden=hidden,
            img_dim=swin_config.num_features, text_dim=text_config.hidden_size,
            num_rs_gcn=num_rs_gcn, num_hidden=num_hidden,
            max_nodes=max_nodes, pos_dim=pos_dim)

    def line_batch(self, slots: int, line_rows: Optional[int] = None) -> int:
        """Rows the per-line encoder runs over ``slots`` line slots: the
        model's ``node_capacity``, else ``line_rows``, else every slot."""
        cap = self.node_capacity
        if cap is None:
            cap = line_rows
        return slots if cap is None else min(cap, slots)

    def forward(self, func_ids, node_ids, image, pos, adj, node_mask,
                train: bool = False, gen: Optional[torch.Generator] = None,
                line_rows: Optional[int] = None):
        """``train``: dropout/DropPath masks from ``gen`` (none without
        one) and batch statistics in the fusion head's BatchNorms.
        ``line_rows``: the packed line capacity of this call where the
        model has no ``node_capacity``; it must hold every valid line."""
        pad = self.text_config.pad_token_id
        encoder = self.text_encoder
        gen = gen if train else None

        # whole-function sentence embedding
        fmask = (func_ids != pad).long()
        text_emb = masked_mean(encoder(func_ids, fmask, gen), fmask)  # [B, H]

        # per-line node embeddings through the SAME encoder
        B, N, Tn = node_ids.shape
        flat = node_ids.reshape(B * N, Tn)
        valid = node_mask.reshape(B * N) > 0
        P = self.line_batch(B * N, line_rows)
        if P < B * N:
            # stable sort brings valid lines to the front in original order
            order = torch.argsort((~valid).to(torch.int32), stable=True)
            sel = order[:P]
            took = valid[sel].float()
            packed = flat[sel]                                    # [P, Tn]
            pmask = (packed != pad).long()
            pgen = None if gen is None else SlotRows(gen, B * N, sel)
            pemb = (masked_mean(encoder(packed, pmask, pgen), pmask)
                    * took[:, None])
            node_flat = torch.zeros((B * N, pemb.shape[-1]), dtype=pemb.dtype,
                                    device=pemb.device).index_put((sel,), pemb)
            node_emb = node_flat.reshape(B, N, -1)
        else:
            nmask = (flat != pad).long()
            node_emb = masked_mean(encoder(flat, nmask, gen),
                                   nmask).reshape(B, N, -1)
        node_emb = node_emb * node_mask[..., None]                # [B, N, H]

        img_emb = self.swin(image, train, gen)
        return self.fusion(img_emb, text_emb, node_emb, pos, adj, node_mask,
                           train=train, gen=gen)
