"""UniXcoder model surface: the classifier head, the embedder and the LM.

Counterpart of ``mvuld_tpu/models/unixcoder.py`` (reference
mvuld/models/unixcoder.py:20-95 and the cUniXcoder baseline's DefectModel):

  * ``UniXcoderClassifier`` — encoder + masked-mean pooling + Linear(H, 2),
    the text stage's model (``train/train_text.py``);
  * ``UniXcoderEmbedder`` — encoder only, returning (token embeddings,
    sentence embeddings): the whole-function text feature and, on a batch of
    per-line snippets, the node features of the fusion caches;
  * ``UniXcoderLM`` — the decoder-only mode: the causal encoder and an LM
    head tied to the word embeddings, and ``beam_search_generate`` over it
    (reference unixcoder.py:110-116, 176-343).

All hold the encoder as ``encoder`` with HF parameter names, so an HF
``pytorch_model.bin`` loads straight into it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

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


class UniXcoderLM(nn.Module):
    """Decoder-mode UniXcoder: the causal encoder and an LM head tied to
    the word embeddings (reference unixcoder.py:110-116: lm_head.weight =
    embeddings.word_embeddings.weight), so it has no parameter of its own.
    Returns logits [B, T, V] in the compute dtype; the head product is a
    plain ``torch.matmul``, as JAX computes it outside any Pallas kernel.
    With ``use_pallas_mlp`` the encoder's MLP halves run K4 (K4b in
    training)."""

    def __init__(self, config: RobertaConfig):
        super().__init__()
        self.config = config
        self.encoder = RobertaEncoder(config, causal=True)

    def forward(self, input_ids: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        hidden = self.encoder(input_ids.long(), gen=gen if train else None)
        embed = self.encoder.embeddings.word_embeddings.weight
        return torch.matmul(hidden, embed.to(hidden.dtype).t())


@torch.no_grad()
def beam_search_generate(model: UniXcoderLM, prefix_ids, beam_size: int = 5,
                         max_length: int = 64, eos_id: int = 2,
                         pad_id: int = 1) -> List[List[int]]:
    """Beam-search decoding over a causal LM (reference UniXcoder.generate
    + Beam, unixcoder.py:176-343; the JAX ``beam_search_generate``): a host
    loop that re-scores the full prefixes of the live beams each step,
    takes the log-softmax of each beam's last real position, its top
    ``beam_size`` tokens by ``np.argsort(-logp)`` on the row as numpy,
    carries finished beams over and keeps the best ``beam_size`` candidates
    by a stable sort on the score — JAX's order exactly, so ties break the
    same way. Returns the best sequence per row of ``prefix_ids`` [B, T]
    (pads dropped) as lists of ids."""
    device = next(model.parameters()).device
    results = []
    for row in np.asarray(prefix_ids):
        prefix = [int(t) for t in row if int(t) != pad_id]
        beams = [(0.0, prefix, False)]
        for _ in range(max_length - len(prefix)):
            if all(done for _, _, done in beams):
                break
            candidates = []
            alive = [b for b in beams if not b[2]]
            batch = np.full((len(alive), max(len(b[1]) for b in alive)),
                            pad_id, np.int64)
            for i, (_, seq, _) in enumerate(alive):
                batch[i, :len(seq)] = seq
            logits = model(torch.as_tensor(batch, device=device))
            last = torch.as_tensor([len(seq) - 1 for _, seq, _ in alive],
                                   device=device)
            rows = logits[torch.arange(len(alive), device=device), last]
            logp = torch.log_softmax(rows, -1).float().cpu().numpy()
            for i, (score, seq, _) in enumerate(alive):
                for tok in np.argsort(-logp[i])[:beam_size]:
                    tok = int(tok)
                    candidates.append((score + float(logp[i, tok]),
                                       seq + [tok], tok == eos_id))
            candidates.extend(b for b in beams if b[2])
            beams = sorted(candidates, key=lambda b: -b[0])[:beam_size]
        results.append(beams[0][1])
    return results
