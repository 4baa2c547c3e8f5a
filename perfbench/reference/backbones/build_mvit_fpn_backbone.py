"""MViTv2 of ``MODEL.MVIT`` for the FPN, with ``MODEL.MVIT.DROP_PATH_RATE``'s
stochastic depth in training."""
from ..models.mvit import MViT


def build(cfg, dtype):
    m = cfg.MODEL.MVIT
    trunk = MViT(embed_dim=m.EMBED_DIM, depth=m.DEPTH, num_heads=m.NUM_HEADS,
                 last_block_indexes=tuple(m.LAST_BLOCK_INDEXES), qkv_pool_kernel=m.QKV_POOL_KERNEL,
                 adaptive_kv_stride=m.ADAPTIVE_KV_STRIDE, adaptive_window_size=m.ADAPTIVE_WINDOW_SIZE,
                 residual_pooling=m.RESIDUAL_POOLING, mlp_ratio=m.MLP_RATIO, pretrain_size=m.PRETRAIN_SIZE,
                 drop_path_rate=m.get("DROP_PATH_RATE", 0.0), compute_dtype=dtype)
    return trunk, tuple(trunk.widths)
