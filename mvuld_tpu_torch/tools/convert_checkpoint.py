"""Offline checkpoint conversion CLI: released torch weights → a port
checkpoint.

Counterpart of ``mvuld_tpu/tools/convert_checkpoint.py`` (same kinds and
flags), writing ``core/checkpoint.save_checkpoint``'s file
``OUT_DIR/checkpoints/ckpt_epoch_0`` holding ``{"params": state_dict}``
instead of an orbax directory. It converts:

  * SwinV2 ImageNet checkpoints (``.pth`` with a ``model`` state dict)
    through ``models/swin_convert.convert_swinv2_state_dict`` into the
    ``SwinTransformerV2`` the flags describe (with its head): the
    cross-window/resolution surgery of the 384→448, window 24→28 fine-tune
    (mvuld/utils.py:31-141) and the head. ``pipeline --swin-ckpt OUT_DIR``
    (or the file) loads the result;
  * UniXcoder / fine-tuned RoBERTa ``pytorch_model.bin`` through
    ``utils/torch_convert.roberta_torch_to_port`` (``--layers``,
    ``--prefix``): the ``RobertaEncoder`` state dict.

``--scan-layout`` repacks the JAX model's blocks for its ``lax.scan``
over block pairs, a TPU layout device; the port has no scanned layout, so
the flag is accepted and changes nothing.

Usage:
  python -m mvuld_tpu_torch.tools.convert_checkpoint swinv2 in.pth out_dir \
      [--img-size 448] [--window 28] [--num-classes 2]
  python -m mvuld_tpu_torch.tools.convert_checkpoint roberta \
      pytorch_model.bin out_dir [--layers 12] [--prefix roberta.]
"""

from __future__ import annotations

import argparse


def _ints(text: str):
    return tuple(int(x) for x in text.split(","))


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("kind", choices=["swinv2", "roberta"])
    parser.add_argument("src")
    parser.add_argument("out_dir")
    parser.add_argument("--img-size", type=int, default=448)
    parser.add_argument("--window", type=int, default=28)
    parser.add_argument("--num-classes", type=int, default=2)
    parser.add_argument("--embed-dim", type=int, default=128)
    parser.add_argument("--depths", default="2,2,18,2")
    parser.add_argument("--heads", default="4,8,16,32")
    parser.add_argument("--pretrained-windows", default="12,12,12,6")
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--prefix", default="")
    parser.add_argument("--scan-layout", action="store_true",
                        help="accepted for the JAX CLI's flags; the port has "
                             "no scanned layout, so it changes nothing")
    args = parser.parse_args(argv)

    import torch

    from mvuld_tpu_torch.core.checkpoint import save_checkpoint

    sd = torch.load(args.src, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]

    if args.kind == "swinv2":
        from mvuld_tpu_torch.models.swin_convert import \
            convert_swinv2_state_dict
        from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                    SwinV2Config)
        cfg = SwinV2Config(
            img_size=args.img_size, embed_dim=args.embed_dim,
            depths=_ints(args.depths), num_heads=_ints(args.heads),
            window_size=args.window,
            pretrained_window_sizes=_ints(args.pretrained_windows))
        model = SwinTransformerV2(cfg, num_classes=args.num_classes)
        params = convert_swinv2_state_dict(sd, model)
    else:
        from mvuld_tpu_torch.utils.torch_convert import roberta_torch_to_port
        params = roberta_torch_to_port(sd, num_layers=args.layers,
                                       prefix=args.prefix)

    path = save_checkpoint(args.out_dir, 0, {"params": params})
    print(f"converted {args.kind} checkpoint → {path}")
    return path


if __name__ == "__main__":
    main()
