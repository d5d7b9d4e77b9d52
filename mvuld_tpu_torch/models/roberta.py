"""RoBERTa encoder in PyTorch — the text-modality backbone (UniXcoder).

Counterpart of ``mvuld_tpu/models/roberta.py``: token embeddings →
post-LN transformer layers → last hidden state. Module and
parameter names are HF ``RobertaModel``'s (``embeddings.word_embeddings``,
``encoder.layer.{i}.attention.self.query`` …), so ``models/convert.py`` maps
the JAX variables onto them one to one.

Activations run in ``config.dtype`` with fp32 parameters; the attention
softmax is fp32 (fp64 for an fp64 model). ``use_pallas_mlp`` runs each
layer's MLP half through the fused ``mlp_ln_res`` kernel
(``ops/fused_dense.py``, K4; K4b backward).
Given a generator, ``forward`` trains: dropout at ``dropout_rate`` on the
embeddings, the attention probabilities, the attention output and the MLP
output — on the kernel path the last is K4's {0,1} keep-mask of hidden's
shape and dtype, drawn where the plain path draws its dropout mask.
``remat`` checkpoints each layer in training (``torch.utils.checkpoint``,
the JAX ``RobertaEncoder(remat=True)``): a layer's activations are rebuilt
in the backward pass, and the rebuilt layer draws the dropout masks its
first run drew (``models/dropout.StageRng``). ``causal`` adds the
decoder-only mode's lower-triangular bias (``UniXcoderLM``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mvuld_tpu_torch.models.dropout import StageRng, dropout, keep_mask
from mvuld_tpu_torch.models.swin_v2 import acc_dtype, layer_norm, linear
from mvuld_tpu_torch.ops.fused_dense import gelu, mlp_ln_res


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 51416          # microsoft/unixcoder-base-nine
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1026
    type_vocab_size: int = 10
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32   # compute dtype; params stay fp32
    use_pallas_mlp: bool = False


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """RoBERTa position ids: pad positions get ``padding_idx``; real tokens get
    ``padding_idx + running count`` (so the first token is at padding_idx+1).
    """
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=-1) * mask + pad_token_id


class SelfAttention(nn.Module):
    """Query/key/value projections and the softmax attention (HF
    ``RobertaSelfAttention``); the output projection is the layer's
    ``attention.output.dense``."""

    def __init__(self, config: RobertaConfig):
        super().__init__()
        c = self.config = config
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size)
        self.value = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                gen=None):
        c = self.config
        hd = c.hidden_size // c.num_heads

        def split(layer):
            y = linear(hidden, layer, c.dtype)
            return y.reshape(y.shape[:-1] + (c.num_heads, hd)).transpose(1, 2)

        q, k, v = split(self.query), split(self.key), split(self.value)
        # [B, H, Tq, Tk] — softmax in fp32 (fp64 for an fp64 model)
        logits = ((q @ k.transpose(-1, -2)).to(acc_dtype(c.dtype))
                  * (1.0 / hd ** 0.5))
        probs = torch.softmax(logits + attn_bias, dim=-1).to(c.dtype)
        probs = dropout(probs, c.dropout_rate, gen)
        ctx = (probs @ v).transpose(1, 2)                   # [B, T, H, hd]
        return ctx.reshape(ctx.shape[:2] + (c.hidden_size,))


class DenseLN(nn.Module):
    """``dense`` + ``LayerNorm`` pair (HF RobertaSelfOutput / RobertaOutput)."""

    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)


class Attention(nn.Module):
    """HF RobertaAttention: ``self`` and ``output``."""

    def __init__(self, config: RobertaConfig):
        super().__init__()
        self.self = SelfAttention(config)
        self.output = DenseLN(config.hidden_size, config.hidden_size,
                              config.layer_norm_eps)


class Intermediate(nn.Module):
    def __init__(self, config: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size)


class TransformerLayer(nn.Module):
    """Post-LN transformer layer (BERT/RoBERTa style)."""

    def __init__(self, config: RobertaConfig):
        super().__init__()
        c = self.config = config
        self.attention = Attention(c)
        self.intermediate = Intermediate(c)
        self.output = DenseLN(c.intermediate_size, c.hidden_size,
                              c.layer_norm_eps)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                gen=None):
        c = self.config
        rate = c.dropout_rate if gen is not None else 0.0
        att = self.attention
        attn_out = linear(att.self(hidden, attn_bias, gen), att.output.dense,
                          c.dtype)
        attn_out = dropout(attn_out, rate, gen)
        hidden = layer_norm(hidden + attn_out, att.output.LayerNorm, c.dtype)
        fc1, fc2, ln = self.intermediate.dense, self.output.dense, self.output.LayerNorm
        if c.use_pallas_mlp:
            mask = (keep_mask(hidden.shape, rate, gen, hidden.device)
                    .to(c.dtype) if rate > 0 else None)
            return mlp_ln_res(hidden.to(c.dtype), fc1.weight.t(), fc1.bias,
                              fc2.weight.t(), fc2.bias, ln.weight, ln.bias,
                              mask, 1.0 - rate)
        mlp = linear(gelu(linear(hidden, fc1, c.dtype)), fc2, c.dtype)
        mlp = dropout(mlp, rate, gen)
        return layer_norm(hidden + mlp, ln, c.dtype)


def checkpointed_layer(layer: nn.Module, hidden: torch.Tensor,
                       attn_bias: torch.Tensor, gen) -> torch.Tensor:
    """``layer(hidden, attn_bias, gen)`` under activation checkpointing. The
    layer draws through a ``StageRng``: the recomputation draws the first
    run's masks, and ``gen`` advances once."""
    if gen is None:
        return checkpoint(layer, hidden, attn_bias, use_reentrant=False,
                          preserve_rng_state=False)
    rng = StageRng(gen)
    return checkpoint(lambda h, b: rng.run(layer, h, b), hidden, attn_bias,
                      use_reentrant=False, preserve_rng_state=False)

    return checkpoint(run, hidden, attn_bias, use_reentrant=False,
                      preserve_rng_state=False)


class Embeddings(nn.Module):
    def __init__(self, config: RobertaConfig):
        super().__init__()
        c = config
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class Encoder(nn.Module):
    def __init__(self, config: RobertaConfig):
        super().__init__()
        self.layer = nn.ModuleList(TransformerLayer(config)
                                   for _ in range(config.num_layers))


class RobertaEncoder(nn.Module):
    """Embeddings + transformer stack → last hidden state [B, T, H].

    ``causal=True`` adds a lower-triangular mask: −1e9 above the diagonal,
    added to the key-side pad bias — the reference's decoder-only mode
    (UniXcoder registers a tril bias buffer, unixcoder.py:113, used for
    generation)."""

    def __init__(self, config: RobertaConfig, remat: bool = False,
                 causal: bool = False):
        super().__init__()
        self.config = config
        self.remat, self.causal = remat, causal
        self.embeddings = Embeddings(config)
        self.encoder = Encoder(config)

    def embed(self, input_ids: torch.Tensor, gen=None) -> torch.Tensor:
        """Word + position + token-type embeddings, LayerNorm, dropout."""
        c = self.config
        emb = self.embeddings
        pos_ids = roberta_position_ids(input_ids, c.pad_token_id)
        hidden = (emb.word_embeddings.weight.to(c.dtype)[input_ids]
                  + emb.position_embeddings.weight.to(c.dtype)[pos_ids]
                  + emb.token_type_embeddings.weight[0].to(c.dtype))
        return dropout(layer_norm(hidden, emb.LayerNorm, c.dtype),
                       c.dropout_rate, gen)

    def attention_bias(self, attention_mask: torch.Tensor) -> torch.Tensor:
        """The additive fp32 bias [B, 1, 1 or T, T]: the key-side pad mask,
        broadcast over heads and query positions, plus the causal one."""
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9
                           ).float()
        if self.causal:
            T = attention_mask.shape[-1]
            tril = torch.ones(T, T, device=bias.device).tril()
            bias = bias + torch.where(tril > 0, 0.0, -1e9)[None, None]
        return bias

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                gen=None) -> torch.Tensor:
        """``attention_mask``: 1 on real tokens (by default where the ids
        are not the pad id); ``gen``: the dropout generator (training), or
        None."""
        if attention_mask is None:
            attention_mask = (input_ids != self.config.pad_token_id).long()
        hidden = self.embed(input_ids, gen)
        attn_bias = self.attention_bias(attention_mask)
        remat = self.remat and torch.is_grad_enabled() and hidden.requires_grad
        for layer in self.encoder.layer:
            hidden = (checkpointed_layer(layer, hidden, attn_bias, gen)
                      if remat else layer(hidden, attn_bias, gen))
        return hidden


def masked_mean(token_embeddings: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sentence embedding = mean of token embeddings over non-pad positions
    (reference: mvuld/models/unixcoder.py get_xcode_vec:33-38).
    """
    m = mask.to(token_embeddings.dtype)[..., None]
    return (token_embeddings * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
