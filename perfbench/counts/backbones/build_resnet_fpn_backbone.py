"""ResNet of ``MODEL.RESNETS.DEPTH`` (the stride in the first 1x1, d2's
STRIDE_IN_1X1) and its FPN; stages below ``MODEL.BACKBONE.FREEZE_AT`` are
frozen."""
from __future__ import annotations

from typing import Dict, List

from perfbench.counts.model import Layer, conv_out, fpn

RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def layers(cfg: Dict, h: int, w: int) -> List[Layer]:
    m = cfg["MODEL"]
    return resnet_fpn(h, w, m["RESNETS"]["DEPTH"], m["BACKBONE"]["FREEZE_AT"])


def resnet_fpn(h: int, w: int, depth: int, freeze_at: int) -> List[Layer]:
    layers: List[Layer] = []
    oh, ow = conv_out(h, 7, 2), conv_out(w, 7, 2)
    stem_trains = freeze_at < 1
    layers.append(("stem", oh * ow * 64 * 3 * 49, stem_trains, False))
    oh, ow = conv_out(oh, 3, 2), conv_out(ow, 3, 2)
    grad_flows = stem_trains  # a trainable layer lies before the next one
    cin, width, out, sizes = 64, 64, 256, {}
    for stage, blocks in enumerate(RESNET_BLOCKS[depth]):
        trains = stage + 2 > freeze_at
        for b in range(blocks):
            s = 2 if b == 0 and stage > 0 else 1
            bh, bw = conv_out(oh, 1, s), conv_out(ow, 1, s)
            name = f"res{stage + 2}_block{b}"
            layers.append((f"{name}.conv1", bh * bw * width * cin, trains, grad_flows))
            if b == 0:
                layers.append((f"{name}.shortcut", bh * bw * out * cin, trains, grad_flows))
            grad_flows = grad_flows or trains
            layers.append((f"{name}.conv2", bh * bw * width * width * 9, trains, grad_flows))
            layers.append((f"{name}.conv3", bh * bw * out * width, trains, grad_flows))
            oh, ow, cin = bh, bw, out
        sizes[f"res{stage + 2}"] = (oh, ow, out, grad_flows)
        width, out = width * 2, out * 2
    return layers + fpn(sizes)
