"""The detector's operations, counted from the configuration's shapes.

Every convolution and matrix product of the forward, as multiply-adds at 2
operations each, over the padded bucket the network computes on: the trunk
and its pyramid (``backbones/<MODEL.BACKBONE.NAME>.py``, found by name), the
RPN head on P2-P6 and the box, IoU, PLN and classifier heads on every RoI of
a batch. Elementwise work, norms, softmax, RoIAlign and the cascade are
left out (RoIAlign has its own roofline). A training step adds, per layer,
the gradient of its weights when they train and the gradient of its input
when a trainable layer lies before it; frozen stages (below
``MODEL.BACKBONE.FREEZE_AT``) get neither. Recomputation is never counted.

A layer is (name, multiply-adds of its forward, trainable, input gradient
needed).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from perfbench.harness import specs

Layer = Tuple[str, float, bool, bool]

FPN_CHANNELS = 256


def conv_out(n: int, k: int, s: int) -> int:
    return (n + 2 * ((k - 1) // 2) - k) // s + 1


def fpn(levels: Dict[str, Tuple[int, int, int, bool]]) -> List[Layer]:
    """The FPN over a trunk's ``res<k>`` maps, finest first: ``levels`` maps
    each to (height, width, channels, input gradient needed)."""
    layers: List[Layer] = []
    for level, (lh, lw, c, flows) in levels.items():
        layers.append((f"fpn.lateral_{level}", lh * lw * FPN_CHANNELS * c, True, flows))
        layers.append((f"fpn.output_{level}", lh * lw * FPN_CHANNELS * FPN_CHANNELS * 9, True, True))
    return layers


def rpn_head(h: int, w: int, channels: int = FPN_CHANNELS, anchors: int = 1) -> List[Layer]:
    """The shared 3x3 conv and the two 1x1 predictors on P2-P6."""
    pixels = sum(math.ceil(h / s) * math.ceil(w / s) for s in (4, 8, 16, 32)) + math.ceil(h / 64) * math.ceil(w / 64)
    return [("rpn.conv", pixels * channels * channels * 9, True, True),
            ("rpn.predictors", pixels * channels * anchors * 5, True, True)]


def roi_heads(rois: int, resolution: int = 7, channels: int = FPN_CHANNELS, fc: int = 1024, emb: int = 256,
              known: int = 20) -> List[Layer]:
    """fc1, fc2, box and IoU predictors, PLN encoder and decoder, the
    classifier, and the embeddings' distances to the prototypes."""
    return [("box_head.fc1", rois * channels * resolution**2 * fc, True, True),
            ("box_head.fc2", rois * fc * fc, True, True),
            ("predictors", rois * fc * 5, True, True),
            ("pln", rois * 2 * fc * emb, True, True),
            ("classifier", rois * fc * (known + 1), True, True),
            ("prototypes", rois * emb * known, True, True)]


def proposals_per_image(h: int, w: int, topk: int) -> int:
    """The RoIs the per-level top-k keeps on P2-P6 (every one is computed,
    valid or not)."""
    levels = [math.ceil(h / s) * math.ceil(w / s) for s in (4, 8, 16, 32, 64)]
    return sum(min(topk, n) for n in levels)


def layers(cfg: Dict, bucket: Sequence[int], batch: int, rois_per_image: int) -> List[Layer]:
    """Every layer of a batch of ``batch`` images on ``bucket``."""
    h, w = bucket
    m = cfg["MODEL"]
    trunk = specs.backbone("counts", m["BACKBONE"]["NAME"]).layers(cfg, h, w)
    per_image = trunk + rpn_head(h, w)
    out = [(n, f * batch, t, g) for n, f, t, g in per_image]
    out += roi_heads(batch * rois_per_image, m["ROI_BOX_HEAD"]["POOLER_RESOLUTION"], FPN_CHANNELS,
                     m["ROI_BOX_HEAD"]["FC_DIM"], m["PLN"]["EMD_DIM"], m["ROI_HEADS"]["NUM_KNOWN_CLASSES"])
    return out


def forward_flops(cfg: Dict, bucket: Sequence[int], batch: int, rois_per_image: int) -> float:
    return 2.0 * sum(f for _, f, _, _ in layers(cfg, bucket, batch, rois_per_image))


def train_flops(cfg: Dict, bucket: Sequence[int], batch: int, rois_per_image: int) -> float:
    """Forward, input gradients where needed, weight gradients where
    trained."""
    total = 0.0
    for _, f, trains, grad_in in layers(cfg, bucket, batch, rois_per_image):
        total += 2.0 * f * (1 + int(trains) + int(grad_in))
    return total


def eval_flops(cfg: Dict, bucket: Sequence[int], batch: int) -> float:
    h, w = bucket
    return forward_flops(cfg, bucket, batch, proposals_per_image(h, w, cfg["MODEL"]["RPN"]["PRE_NMS_TOPK_TEST"]))


def step_flops(cfg: Dict, bucket: Sequence[int], batch: int) -> float:
    return train_flops(cfg, bucket, batch, cfg["MODEL"]["ROI_HEADS"]["BATCH_SIZE_PER_IMAGE"])
