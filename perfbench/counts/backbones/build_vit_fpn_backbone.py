"""ViTDet's ViT with windowed and global attention (padded windows) and its
simple pyramid, at ViT-B's widths: the program has no key for a ViT's size.
Every layer trains (``FREEZE_AT`` 0)."""
from __future__ import annotations

import math
from typing import Dict, List

from perfbench.counts.model import FPN_CHANNELS, Layer


def layers(cfg: Dict, h: int, w: int) -> List[Layer]:
    return vit_pyramid(h, w)


def vit_pyramid(h: int, w: int, patch: int = 16, dim: int = 768, depth: int = 12, window: int = 14,
                global_every: int = 3, mlp_ratio: int = 4, out: int = FPN_CHANNELS) -> List[Layer]:
    gh, gw = math.ceil(h / patch), math.ceil(w / patch)
    n = gh * gw
    npad = math.ceil(gh / window) * window * math.ceil(gw / window) * window
    layers: List[Layer] = [("patch_embed", n * dim * 3 * patch * patch, True, False)]
    for i in range(depth):
        is_global = (i + 1) % global_every == 0
        tokens = n if is_global else npad
        attn = 2 * n * n * dim if is_global else 2 * (npad // window**2) * window**4 * dim  # q.k and p.v
        layers += [(f"block{i}.qkv", tokens * dim * 3 * dim, True, True),
                   # no weights, but both operands of each product take a gradient
                   (f"block{i}.attention", attn, True, True),
                   (f"block{i}.proj", tokens * dim * dim, True, True),
                   (f"block{i}.mlp", 2 * n * dim * mlp_ratio * dim, True, True)]
    layers += [("up2a", n * dim * (dim // 2) * 4, True, True),
               ("up2b", 4 * n * (dim // 2) * (dim // 4) * 4, True, True)]
    for level, pixels, cin in (("p2", 16 * n, dim // 4), ("p3", 4 * n, dim // 2), ("p4", n, dim),
                               ("p5", (gh // 2) * (gw // 2), dim)):
        layers += [(f"{level}_conv1", pixels * out * cin, True, True),
                   (f"{level}_conv2", pixels * out * out * 9, True, True)]
    return layers
