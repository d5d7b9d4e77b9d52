"""The reference's training steps and forward passes, in blocks that fit.

* ``draw_e2e_masks`` / ``draw_swin_drops``: the dropout and stochastic-depth
  masks of one training forward, drawn from a ``torch.Generator`` in the
  order the measured trainer draws them (the function text's encoder, then
  the code lines' over every line slot, then SwinV2's per-image masks
  stage by stage, then the head's), so that one seed gives both sides the
  same masks.
* ``e2e_grads``: loss and gradients of the tri-modal model on a batch. The
  towers run in blocks of the batch without gradients, the head on the
  whole batch's features (its BatchNorms need the whole batch), then each
  tower block again with gradients, fed the head's feature gradients.
* ``swin_grads``: loss and gradients of SwinV2 with its head, in blocks of
  images.
* ``AdamW``: optax's clip_by_global_norm then adamw, in fp32.
* ``e2e_probs``: P(vul) of functions in inference (BatchNorm on running
  statistics), in blocks.

This file imports torch and the reference's models only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference.models import (EndToEnd, Masks, SwinV2,
                                        masked_mean)


def _keep(shape, rate, gen, device) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=gen, device=device) < 1.0 - rate


def draw_roberta_masks(model, B: int, T: int, gen, device,
                       pick: Optional[torch.Tensor] = None) -> List:
    """One encoder pass's masks over B rows of T tokens: the embeddings',
    then per layer the attention probabilities', the attention output's and
    the MLP output's; with ``pick`` the rows kept of each."""
    H = model.embeddings.word_embeddings.weight.shape[1]
    heads, rate = model.heads, model.rate
    shapes = [(B, T, H)]
    for _ in model.encoder.layer:
        shapes += [(B, heads, T, T), (B, T, H), (B, T, H)]
    out = []
    for s in shapes:
        m = _keep(s, rate, gen, device)
        out.append(m if pick is None else m[pick])
    return out


def draw_swin_drops(model: SwinV2, B: int, gen, device) -> List:
    """Per block None (rate 0) or (keep-mask [B], keep-mask [B], rate)."""
    out = []
    for r in model.rates():
        out.append((_keep((B,), r, gen, device), _keep((B,), r, gen, device),
                    r) if r > 0 else None)
    return out


def draw_head_masks(model: EndToEnd, B: int, N: int, gen, device) -> List:
    g = model.fusion.graph
    rate = model.fusion.rate
    d_in = g.gats.gat.fc.weight.shape[1]
    hidden, heads = g.gats.hidden, g.gats.heads
    shapes = [(B, N, d_in), (B, N, hidden * heads), (B, N, hidden)]
    shapes += [(B, N, hidden)] * g.depth
    return [_keep(s, rate, gen, device) for s in shapes]


def pack_lines(node_mask: torch.Tensor, capacity: Optional[int]):
    """The line slots the trainer encodes: valid lines in slot order, at
    most ``capacity`` of them (later ones get a zero embedding)."""
    valid = node_mask.reshape(-1) > 0
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    n = int(valid.sum())
    if capacity is not None:
        n = min(n, capacity)
    return order[:n]


def draw_e2e_masks(model: EndToEnd, batch: Dict[str, torch.Tensor], gen,
                   capacity: Optional[int]) -> Dict:
    """The masks of one training forward of the tri-modal model. A code
    line's masks are its slot's rows of masks drawn over all B·N line
    slots, whether the lines are packed or not."""
    dev = batch["func_ids"].device
    B, T = batch["func_ids"].shape
    _, N, Tn = batch["node_ids"].shape
    slots = pack_lines(batch["node_mask"], capacity)
    return {"func": draw_roberta_masks(model.text_encoder, B, T, gen, dev),
            "lines": draw_roberta_masks(model.text_encoder, B * N, Tn, gen,
                                        dev, pick=slots),
            "lines_slots": slots,
            "drops": draw_swin_drops(model.swin, B, gen, dev),
            "head": draw_head_masks(model, B, N, gen, dev)}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float, rows: Optional[int] = None
                  ) -> torch.Tensor:
    """Mean CE with label smoothing over ``rows`` (all by default)."""
    C = logits.shape[-1]
    logp = torch.log_softmax(logits, -1)
    t = torch.nn.functional.one_hot(labels.long(), C).to(logp.dtype)
    t = t * (1 - smoothing) + smoothing / C
    per = -(t * logp).sum(-1)
    n = per.shape[0] if rows is None else rows
    return per[:n].sum() / n


def _slice_masks(masks: Sequence, lo: int, hi: int) -> Masks:
    return Masks([m[lo:hi] for m in masks])


def _blocks(n: int, size: int):
    for lo in range(0, n, size):
        yield lo, min(n, lo + size)


def e2e_features(model: EndToEnd, batch, masks: Optional[Dict], blocks,
                 capacity: Optional[int], grads: Optional[Dict] = None):
    """The towers' features (img [B, F], text [B, H], node [B, N, H]); with
    ``grads`` the towers run again with gradients and take the features'
    gradients ``grads`` (backward by blocks)."""
    enc, swin = model.text_encoder, model.swin
    ids, nids = batch["func_ids"].long(), batch["node_ids"].long()
    B, T = ids.shape
    _, N, Tn = nids.shape
    pad = enc.pad_id
    train = masks is not None
    slots = (masks["lines_slots"] if train
             else pack_lines(batch["node_mask"], capacity))
    flat = nids.reshape(B * N, Tn)[slots]
    feats = {"text": [], "node_rows": [], "img": []}

    def run(out, g):
        if grads is None:
            return out.detach()
        torch.autograd.backward(out, g)
        return None

    ctx = torch.enable_grad() if grads is not None else torch.no_grad()
    with ctx:
        for lo, hi in _blocks(B, blocks["text"]):
            m = (_slice_masks(masks["func"], lo, hi) if train else Masks())
            x = ids[lo:hi]
            out = masked_mean(enc(x, m), x != pad)
            feats["text"].append(run(out, None if grads is None
                                     else grads["text"][lo:hi]))
        for lo, hi in _blocks(len(slots), blocks["lines"]):
            m = (_slice_masks(masks["lines"], lo, hi) if train else Masks())
            x = flat[lo:hi]
            out = masked_mean(enc(x, m), x != pad)
            feats["node_rows"].append(run(out, None if grads is None
                                          else grads["node_rows"][lo:hi]))
        for lo, hi in _blocks(B, blocks["image"]):
            drops = masks["drops"] if train else None
            d = (None if drops is None else
                 [None if t is None else (t[0][lo:hi], t[1][lo:hi], t[2])
                  for t in drops])
            out = swin(batch["image"][lo:hi].float(), d)
            feats["img"].append(run(out, None if grads is None
                                    else grads["img"][lo:hi]))
    if grads is not None:
        return None
    H = feats["text"][0].shape[-1]
    node = torch.zeros(B * N, H, device=ids.device)
    if len(slots):
        node[slots] = torch.cat(feats["node_rows"])
    return {"text": torch.cat(feats["text"]), "img": torch.cat(feats["img"]),
            "node": node.reshape(B, N, H), "slots": slots}


def e2e_grads(model: EndToEnd, batch, masks: Dict, smoothing: float,
              blocks, capacity: Optional[int], half: bool = False):
    """Loss of one training step of the tri-modal model; the parameters'
    ``.grad`` hold its gradients (accumulated: zero them first).
    ``half``: the loss over the first half of the batch only (a planted
    fault)."""
    f = e2e_features(model, batch, masks, blocks, capacity)
    img = f["img"].requires_grad_()
    text = f["text"].requires_grad_()
    node = f["node"].requires_grad_()
    nm = batch["node_mask"].float()
    logits = model.fusion(img, text, node * nm[..., None],
                          batch["pos"].float(), batch["adj"] > 0, nm, True,
                          Masks(masks["head"]))
    B = logits.shape[0]
    loss = cross_entropy(logits, batch["label"], smoothing,
                         B // 2 if half else None)
    loss.backward()
    slots = f["slots"]
    g_node = node.grad.reshape(-1, node.shape[-1])[slots]
    e2e_features(model, batch, masks, blocks, capacity,
                 grads={"img": img.grad, "text": text.grad,
                        "node_rows": g_node})
    return loss.detach()


def swin_grads(model: SwinV2, images, labels, drops, smoothing: float,
               block: int, half: bool = False):
    """Loss of one training step of SwinV2 with its head, by blocks of
    images; the parameters' ``.grad`` hold its gradients."""
    B = images.shape[0]
    n = B // 2 if half else B
    total = torch.zeros((), device=images.device)
    for lo, hi in _blocks(n, block):
        d = [None if t is None else (t[0][lo:hi], t[1][lo:hi], t[2])
             for t in drops]
        logits = model(images[lo:hi].float(), d)
        C = logits.shape[-1]
        logp = torch.log_softmax(logits, -1)
        t = torch.nn.functional.one_hot(labels[lo:hi].long(), C).to(logp.dtype)
        t = t * (1 - smoothing) + smoothing / C
        loss = -(t * logp).sum() / n
        loss.backward()
        total += loss.detach()
    return total


def e2e_probs(model: EndToEnd, rows: Dict[str, torch.Tensor], blocks
              ) -> torch.Tensor:
    """P(vul) of every row in inference."""
    out = []
    B = rows["func_ids"].shape[0]
    for lo, hi in _blocks(B, blocks["image"]):
        batch = {k: v[lo:hi] for k, v in rows.items()}
        f = e2e_features(model, batch, None, blocks, None)
        nm = batch["node_mask"].float()
        with torch.no_grad():
            logits = model.fusion(f["img"], f["text"],
                                  f["node"] * nm[..., None],
                                  batch["pos"].float(), batch["adj"] > 0, nm,
                                  False, Masks())
        out.append(torch.softmax(logits, -1)[:, 1])
    return torch.cat(out)


class AdamW:
    """optax.chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps, wd))
    over named parameters, with weight decay on ``decay`` names."""

    def __init__(self, named: Dict[str, torch.Tensor], lr: float,
                 decay: Dict[str, bool], clip: float, wd: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.named, self.lr, self.decay = named, lr, decay
        self.clip, self.wd, self.b1, self.b2, self.eps = clip, wd, *betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in named.items()}
        self.v = {k: torch.zeros_like(p) for k, p in named.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update from the parameters' ``.grad``; returns the clipped
        gradients."""
        g = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in self.named.items()}
        norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
        c = torch.where(norm < self.clip, torch.ones_like(norm),
                        self.clip / norm)
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, p in self.named.items():
            gk = g[k] * c
            out[k] = gk
            self.m[k].mul_(self.b1).add_((1 - self.b1) * gk)
            self.v[k].mul_(self.b2).add_((1 - self.b2) * gk * gk)
            u = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
            if self.decay[k]:
                u = u + self.wd * p
            p.add_(-self.lr * u)
            p.grad = None
        return out


def decay_names(model: torch.nn.Module) -> Dict[str, bool]:
    """Weight decay on ≥2-d parameters other than the position-bias MLP,
    the logit scales and the embeddings (optax's mask in the configs'
    optimizer)."""
    skip = ("cpb_mlp", "logit_scale", "embeddings")
    return {k: p.dim() > 1 and not any(s in k for s in skip)
            for k, p in model.named_parameters()}
