"""MViTv2 of ``MODEL.MVIT`` and its FPN. Per block: qkv on the block's input
grid; the three depthwise pooling convolutions on their pooled grids; q.k
and p.v over the padded windows (every padded window attends over all its
tokens) or the whole pooled grids; the two relative-position products (each
query against its key rows, and against its key columns); the shortcut's
Linear on the input grid where the width changes; proj and the MLP on the
pooled query grid. The max-pooled shortcut, norms and softmax are left out
as elementwise. Every layer trains."""
from __future__ import annotations

import math
from typing import Dict, List

from perfbench.counts.model import Layer, conv_out, fpn
from perfbench.reference.models.mvit import PATCH, schedule

PATCH_KERNEL = 7


def layers(cfg: Dict, h: int, w: int) -> List[Layer]:
    m = cfg["MODEL"]["MVIT"]
    return mvit_fpn(h, w, m["EMBED_DIM"], m["DEPTH"], m["NUM_HEADS"], m["LAST_BLOCK_INDEXES"],
                    m["QKV_POOL_KERNEL"], m["ADAPTIVE_KV_STRIDE"], m["ADAPTIVE_WINDOW_SIZE"], m["MLP_RATIO"],
                    m["PRETRAIN_SIZE"])


def mvit_fpn(h: int, w: int, embed: int, depth: int, heads: int, last, kernel: int, kv_stride: int, window: int,
             mlp_ratio: float, pretrain_size: int) -> List[Layer]:
    gh, gw = conv_out(h, PATCH_KERNEL, PATCH), conv_out(w, PATCH_KERNEL, PATCH)
    out: List[Layer] = [("patch_embed", gh * gw * embed * 3 * PATCH_KERNEL ** 2, True, False)]
    sizes = {}
    for i, (dim, dim_out, _, sq, skv, win, _) in enumerate(
            schedule(embed, depth, heads, last, kv_stride, window, pretrain_size)):
        qh, qw = conv_out(gh, kernel, sq), conv_out(gw, kernel, sq)
        kh, kw = conv_out(gh, kernel, skv), conv_out(gw, kernel, skv)
        if win:
            wq, wk = win // sq, win // skv
            queries, k_side = math.ceil(qh / wq) * math.ceil(qw / wq) * wq * wq, (wk, wk)
        else:
            queries, k_side = qh * qw, (kh, kw)
        keys = k_side[0] * k_side[1]
        name = f"block{i}"
        out += [(f"{name}.qkv", gh * gw * dim * 3 * dim_out, True, True),
                (f"{name}.pool", (qh * qw + 2 * kh * kw) * dim_out * kernel * kernel, True, True),
                # no weights, but both operands of each product take a gradient
                (f"{name}.attention", 2 * queries * keys * dim_out, True, True),
                (f"{name}.rel_pos", queries * (k_side[0] + k_side[1]) * dim_out, True, True),
                (f"{name}.proj", qh * qw * dim_out * dim_out, True, True),
                (f"{name}.mlp", 2 * qh * qw * dim_out * int(dim_out * mlp_ratio), True, True)]
        if dim != dim_out:
            out.append((f"{name}.shortcut", gh * gw * dim * dim_out, True, True))
        gh, gw = qh, qw
        if i in last:
            sizes[f"res{list(last).index(i) + 2}"] = (gh, gw, dim_out, True)
    return out + fpn(sizes)
