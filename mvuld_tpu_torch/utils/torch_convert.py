"""Released RoBERTa / UniXcoder torch checkpoints → the port's modules.

Counterpart of ``mvuld_tpu/utils/torch_convert.py``, whose name maps turn
an HF ``RobertaModel`` state dict into Flax parameters. The port's
``models/roberta.RobertaEncoder`` carries the HF names, so the map here is
a prefix strip: the encoder's tensors are taken under their own keys, the
pooler and the ``position_ids`` buffer are left behind (the port has
neither), and an encoder tensor the checkpoint lacks raises, as
``train/train_text.load_pretrained_encoder`` does.

``load_unixcoder_checkpoint`` reads the three layouts the reference
ships (baselines/models/cunixcoder): a bare ``RobertaModel``
(microsoft/unixcoder-base-nine ``pytorch_model.bin``), the fine-tuned
``DefectModel`` with the encoder under ``encoder.`` (or ``roberta.``) and a
``classifier`` Linear(hidden, 2), and either one under DataParallel's
``module.`` prefix (cunixcoder main.py:262).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_LAYER_KEYS = ("attention.self.query", "attention.self.key",
               "attention.self.value", "attention.output.dense",
               "attention.output.LayerNorm", "intermediate.dense",
               "output.dense", "output.LayerNorm")


def roberta_keys(num_layers: int) -> List[str]:
    """The state-dict keys of a ``RobertaEncoder`` with ``num_layers``
    layers (HF ``RobertaModel`` names without the pooler)."""
    keys = [f"embeddings.{e}_embeddings.weight"
            for e in ("word", "position", "token_type")]
    keys += ["embeddings.LayerNorm.weight", "embeddings.LayerNorm.bias"]
    for i in range(num_layers):
        keys += [f"encoder.layer.{i}.{m}.{leaf}" for m in _LAYER_KEYS
                 for leaf in ("weight", "bias")]
    return keys


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.as_tensor(np.asarray(v))


def roberta_torch_to_port(state_dict: Mapping[str, object], num_layers: int,
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """An HF ``RobertaModel`` state dict (under ``prefix``, e.g.
    ``"roberta."`` or ``"encoder."``) → the ``RobertaEncoder`` state dict.
    Raises on an encoder tensor left unset."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items()
          if k.startswith(prefix)}
    keys = roberta_keys(num_layers)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"encoder tensors left unset: {missing[:6]}"
                       f"{' …' if len(missing) > 6 else ''}")
    return {k: _tensor(sd[k]) for k in keys}


def linear_torch_to_port(state_dict: Mapping[str, object], key: str
                         ) -> Dict[str, torch.Tensor]:
    """A torch ``nn.Linear`` under ``key`` → its {weight, bias} state."""
    out = {"weight": _tensor(state_dict[key + ".weight"])}
    if key + ".bias" in state_dict:
        out["bias"] = _tensor(state_dict[key + ".bias"])
    return out


def load_unixcoder_checkpoint(state_dict: Mapping[str, object]
                              ) -> Tuple[Dict[str, torch.Tensor],
                                         Optional[Dict[str, torch.Tensor]],
                                         int]:
    """(the ``RobertaEncoder`` state dict, the classifier's ``nn.Linear``
    state or None, num_layers) of a checkpoint of any of the three
    layouts."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in state_dict.items()}
    if any(k.startswith("encoder.embeddings.") for k in sd):
        prefix = "encoder."
    elif any(k.startswith("roberta.embeddings.") for k in sd):
        prefix = "roberta."
    else:
        prefix = ""
    layer_pre = f"{prefix}encoder.layer."
    layers = {int(k[len(layer_pre):].split(".")[0])
              for k in sd if k.startswith(layer_pre)}
    if not layers:
        raise ValueError("no encoder.layer.{i} keys found — not a RobertaModel"
                         " checkpoint")
    num_layers = max(layers) + 1
    encoder = roberta_torch_to_port(sd, num_layers, prefix=prefix)
    classifier = (linear_torch_to_port(sd, "classifier")
                  if "classifier.weight" in sd else None)
    return encoder, classifier, num_layers
