"""EVA-02 of ``MODEL.EVA02`` in the ViTDet frame and its simple pyramid.
Per block: the q/k/v and output projections over the grid padded to window
multiples in a windowed block (every padded window attends over all its
tokens) or over the grid in a global block; q.k and p.v over the padded
windows or the whole grid; SwiGLU's three projections (w1, w2 to the hidden
width, w3 back) over the grid's tokens. RoPE, the norms, the softmax and
SwiGLU's gate are left out as elementwise. The patch embedding and the
pyramid are ``build_vit_fpn_backbone``'s at EVA-02's width. Every layer
trains."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

from perfbench.counts.backbones.build_vit_fpn_backbone import vit_pyramid
from perfbench.counts.model import Layer

PATCH = 16


def layers(cfg: Dict, h: int, w: int) -> List[Layer]:
    m = cfg["MODEL"]["EVA02"]
    return eva02_pyramid(h, w, m["EMBED_DIM"], m["DEPTH"], m["MLP_HIDDEN"], m["WINDOW_SIZE"], m["GLOBAL_BLOCKS"])


def eva02_pyramid(h: int, w: int, dim: int, depth: int, hidden: int, window: int,
                  global_blocks: Sequence[int]) -> List[Layer]:
    gh, gw = math.ceil(h / PATCH), math.ceil(w / PATCH)
    n = gh * gw
    npad = math.ceil(gh / window) * window * math.ceil(gw / window) * window
    # the patch embedding, then the pyramid: the ViT count of no blocks
    patch_embed, *pyramid = vit_pyramid(h, w, patch=PATCH, dim=dim, depth=0)
    blocks: List[Layer] = []
    for i in range(depth):
        is_global = i in global_blocks
        tokens = n if is_global else npad
        attn = 2 * n * n * dim if is_global else 2 * (npad // window**2) * window**4 * dim  # q.k and p.v
        blocks += [(f"block{i}.qkv", tokens * dim * 3 * dim, True, True),
                   # no weights, but both operands of each product take a gradient
                   (f"block{i}.attention", attn, True, True),
                   (f"block{i}.proj", tokens * dim * dim, True, True),
                   (f"block{i}.mlp", 3 * n * dim * hidden, True, True)]
    return [patch_embed] + blocks + pyramid
