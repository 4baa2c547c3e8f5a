"""Convert a reference torch/d2 checkpoint (or a caffe2 ImageNet pkl, an
official Swin or a timm/ViTDet ViT checkpoint) into a port checkpoint that
``MODEL.WEIGHTS`` loads:

    python -m openset_rcnn_tpu_torch.tools.convert_checkpoint \\
        --config-file configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml \\
        --src model_final.pth --dst converted.pt [--swin | --vit]

Port of ``tools/convert_checkpoint.py``. It writes ``{"model": state_dict}``
with ``torch.save`` where the JAX tool writes an Orbax directory; tensors the
source lacks keep the config's seeded random init (``SEED``).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="reference checkpoint -> port checkpoint (.pt)")
    p.add_argument("--config-file", required=True)
    p.add_argument("--src", required=True, help=".pth / .pkl checkpoint")
    p.add_argument("--dst", required=True, help="output port checkpoint (.pt)")
    kind = p.add_mutually_exclusive_group()
    kind.add_argument("--swin", action="store_true", help="src is an official Swin ImageNet checkpoint (backbone only)")
    kind.add_argument("--vit", action="store_true", help="src is a timm/MAE ViT checkpoint (trunk only; pos_embed is "
                      "bicubically resized into the static table)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Convert ``--src`` and write ``--dst``; returns ``--dst``."""
    args = get_parser().parse_args(argv)

    from ..config import get_default_cfg
    from ..models.detector import ModelSpec, build_model
    from ..utils import torch_weights

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    # a host job: the model only supplies names, shapes and the init of what the source lacks
    model = build_model(ModelSpec.from_cfg(cfg), "cpu", seed=max(cfg.SEED, 0))
    if args.swin:
        state = torch_weights.convert_swin_torch(args.src, model, size=cfg.MODEL.SWIN.SIZE)
    elif args.vit:
        state = torch_weights.convert_vit_torch(args.src, model)
    else:
        state = torch_weights.convert_torch_checkpoint(args.src, model)
    torch.save({"model": state}, args.dst)
    print(f"wrote {args.dst}; use MODEL.WEIGHTS {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
