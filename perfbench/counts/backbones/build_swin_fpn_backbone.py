"""Swin Transformer of ``MODEL.SWIN.SIZE`` and ``MODEL.SWIN.WINDOW`` and its
FPN. Each block's qkv and output projections run over its grid padded to
window multiples, and so do q.k and p.v (every padded window attends over
all its tokens); the MLP runs over the real tokens. Every layer trains (the
frozen-stage rule names no Swin parameter)."""
from __future__ import annotations

import math
from typing import Dict, List

from perfbench.counts.model import Layer, fpn
from perfbench.reference.models.swin import PATCH, VARIANTS

MLP_RATIO = 4


def layers(cfg: Dict, h: int, w: int) -> List[Layer]:
    s = cfg["MODEL"]["SWIN"]
    embed, depths, _ = VARIANTS[s["SIZE"]]
    return swin_fpn(h, w, embed, depths, s["WINDOW"])


def swin_fpn(h: int, w: int, embed: int, depths, window: int) -> List[Layer]:
    gh, gw = math.ceil(h / PATCH), math.ceil(w / PATCH)
    layers: List[Layer] = [("patch_embed", gh * gw * embed * 3 * PATCH * PATCH, True, False)]
    dim, sizes = embed, {}
    for s, depth in enumerate(depths):
        if s:
            gh, gw = math.ceil(gh / 2), math.ceil(gw / 2)
            layers.append((f"downsample{s - 1}", gh * gw * 4 * dim * 2 * dim, True, True))
            dim *= 2
        tokens = gh * gw
        padded = math.ceil(gh / window) * window * math.ceil(gw / window) * window
        for b in range(depth):
            name = f"stage{s}_block{b}"
            layers += [(f"{name}.qkv", padded * dim * 3 * dim, True, True),
                       # no weights, but both operands of each product take a gradient
                       (f"{name}.attention", 2 * padded * window * window * dim, True, True),
                       (f"{name}.proj", padded * dim * dim, True, True),
                       (f"{name}.mlp", 2 * tokens * dim * MLP_RATIO * dim, True, True)]
        sizes[f"res{s + 2}"] = (gh, gw, dim, True)
    return layers + fpn(sizes)
