"""EVA-02 of ``MODEL.EVA02`` in the ViTDet frame, with the simple pyramid,
which emits ``p2``..``p6`` itself (no FPN); ``MODEL.EVA02.DROP_PATH_RATE``'s
stochastic depth in training."""
from ..models.eva02 import EVA02


def build(cfg, dtype):
    m = cfg.MODEL.EVA02
    trunk = EVA02(embed_dim=m.EMBED_DIM, depth=m.DEPTH, num_heads=m.NUM_HEADS, mlp_hidden=m.MLP_HIDDEN,
                  window=m.WINDOW_SIZE, global_blocks=tuple(m.GLOBAL_BLOCKS), pos_grid=m.POS_GRID,
                  rope_pt=m.ROPE_PT, rope_global_ft=m.ROPE_GLOBAL_FT, drop_path_rate=m.get("DROP_PATH_RATE", 0.0),
                  compute_dtype=dtype)
    return trunk, None
