"""End-to-end tri-modal model construction (counterpart of
``mvuld_tpu/train/train_e2e.py``). Only ``build_e2e_model`` is ported in
this slice: the serving CLI (``train/predict.py``) rebuilds a finished
run's model from its saved config with it. The trainer comes with the
training slice.
"""

from __future__ import annotations


def build_e2e_model(cfg, vocab_size: int, node_capacity=None, **overrides):
    """EndToEndMVulD + its Roberta/Swin configs from one resolved config, so
    a finished run's config.json rebuilds the exact parameter tree.
    ``roberta_pallas_mlp`` turns on the text encoder's fused MLP (K4); the
    other overrides are EndToEndMVulD keywords (``use_pallas``,
    ``use_pallas_mlp``, ``window_resident``)."""
    import torch

    from mvuld_tpu_torch.models.e2e import EndToEndMVulD
    from mvuld_tpu_torch.models.roberta import RobertaConfig
    from mvuld_tpu_torch.models.swin_v2 import SwinV2Config

    u = cfg.MODEL.UNIXCODER
    rcfg = RobertaConfig(
        vocab_size=max(vocab_size, 16), hidden_size=u.HIDDEN,
        num_layers=u.LAYERS, num_heads=u.HEADS,
        intermediate_size=u.INTERMEDIATE,
        max_position_embeddings=u.MAX_POSITIONS,
        use_pallas_mlp=overrides.pop("roberta_pallas_mlp", False),
        dtype=(torch.bfloat16 if cfg.PARALLEL.DTYPE == "bfloat16"
               else torch.float32))
    scfg = SwinV2Config.from_cfg(cfg)
    kwargs = dict(hidden=cfg.MODEL.MULTI.HIDDEN,
                  num_classes=cfg.MODEL.NUM_CLASSES,
                  num_rs_gcn=cfg.MODEL.MULTI.NUM_RS_GCN,
                  num_hidden=cfg.MODEL.MULTI.NUM_HIDDEN_FC,
                  max_nodes=cfg.DATA.MAX_NODES,
                  pos_dim=4 + 2 * int(cfg.DATA.NODE_NUMERIC),
                  node_capacity=node_capacity)
    kwargs.update(overrides)
    return EndToEndMVulD(rcfg, scfg, **kwargs), rcfg, scfg
