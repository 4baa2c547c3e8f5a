"""ResNet of ``MODEL.RESNETS.DEPTH`` for the FPN; ``TPU.REMAT`` recomputes
its blocks in the backward."""
from ..models.resnet import RES2_OUT_CHANNELS, ResNet


def build(cfg, dtype):
    trunk = ResNet(depth=cfg.MODEL.RESNETS.DEPTH, compute_dtype=dtype, remat=cfg.TPU.get("REMAT", False))
    return trunk, tuple(RES2_OUT_CHANNELS << i for i in range(4))
