"""ViTDet's ViT-B with its simple pyramid, which emits ``p2``..``p6``
itself (no FPN)."""
from ..models.vit import ViTSimpleFPN


def build(cfg, dtype):
    m = cfg.MODEL
    drop_path = m.VIT.get("DROP_PATH_RATE", 0.0) if "VIT" in m else 0.0
    return ViTSimpleFPN(compute_dtype=dtype, drop_path_rate=drop_path), None
