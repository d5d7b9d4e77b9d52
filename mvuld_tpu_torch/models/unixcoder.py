"""UniXcoder model surface: the classifier head and the embedder.

Counterpart of ``mvuld_tpu/models/unixcoder.py`` (reference
mvuld/models/unixcoder.py:20-95 and the cUniXcoder baseline's DefectModel):

  * ``UniXcoderClassifier`` — encoder + masked-mean pooling + Linear(H, 2),
    the text stage's model (``train/train_text.py``);
  * ``UniXcoderEmbedder`` — encoder only, returning (token embeddings,
    sentence embeddings): the whole-function text feature and, on a batch of
    per-line snippets, the node features of the fusion caches.

Both hold the encoder as ``encoder`` with HF parameter names, so an HF
``pytorch_model.bin`` loads straight into it. ``UniXcoderLM`` and
``beam_search_generate`` need the causal encoder, which the port does not
have yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mvuld_tpu_torch.models.roberta import (RobertaConfig, RobertaEncoder,
                                            masked_mean)
from mvuld_tpu_torch.models.swin_v2 import linear


class UniXcoderEmbedder(nn.Module):
    """Encoder-only forward returning (token_embeddings [B, T, H],
    sentence_embeddings [B, H])."""

    def __init__(self, config: RobertaConfig, remat: bool = False):
        super().__init__()
        self.config = config
        self.encoder = RobertaEncoder(config, remat=remat)

    def forward(self, source_ids: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        mask = (source_ids != self.config.pad_token_id).long()
        tokens = self.encoder(source_ids.long(), mask, gen if train else None)
        return tokens, masked_mean(tokens, mask)


class UniXcoderClassifier(UniXcoderEmbedder):
    """Encoder + masked-mean pooling + linear head: (fp32 logits [B,
    num_classes], sentence embeddings [B, H])."""

    def __init__(self, config: RobertaConfig, num_classes: int = 2,
                 remat: bool = False):
        super().__init__(config, remat)
        self.classifier = nn.Linear(config.hidden_size, num_classes)

    def forward(self, source_ids: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        _tokens, sent = super().forward(source_ids, train, gen)
        logits = linear(sent, self.classifier, self.config.dtype)
        return logits.float(), sent
