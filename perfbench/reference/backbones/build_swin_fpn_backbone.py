"""Swin Transformer of ``MODEL.SWIN.SIZE`` (T, S or B) and
``MODEL.SWIN.WINDOW`` for the FPN, with ``MODEL.SWIN.DROP_PATH_RATE``'s
stochastic depth in training."""
from ..models.swin import SwinTransformer


def build(cfg, dtype):
    s = cfg.MODEL.SWIN
    trunk = SwinTransformer(size=s.SIZE, window=s.WINDOW, compute_dtype=dtype,
                            drop_path_rate=s.get("DROP_PATH_RATE", 0.0))
    return trunk, tuple(trunk.widths)
