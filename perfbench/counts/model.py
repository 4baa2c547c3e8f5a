"""The detector's operations, counted from the configuration's shapes.

Every convolution and matrix product of the forward, as multiply-adds at 2
operations each, over the padded bucket the network computes on: the
backbone (ResNet-50 + FPN, or ViTDet's ViT-B and its simple pyramid), the
RPN head on P2-P6 and the box, IoU, PLN and classifier heads on every RoI
of a batch. Elementwise work, norms, softmax, RoIAlign and the cascade are
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

Layer = Tuple[str, float, bool, bool]

RESNET_BLOCKS = {50: (3, 4, 6, 3)}
FPN_CHANNELS = 256


def _conv_out(n: int, k: int, s: int) -> int:
    return (n + 2 * ((k - 1) // 2) - k) // s + 1


def resnet_fpn(h: int, w: int, depth: int, freeze_at: int) -> List[Layer]:
    """ResNet (stride in the first 1x1, d2's STRIDE_IN_1X1) and FPN."""
    layers: List[Layer] = []
    oh, ow = _conv_out(h, 7, 2), _conv_out(w, 7, 2)
    stem_trains = freeze_at < 1
    layers.append(("stem", oh * ow * 64 * 3 * 49, stem_trains, False))
    oh, ow = _conv_out(oh, 3, 2), _conv_out(ow, 3, 2)
    grad_flows = stem_trains  # a trainable layer lies before the next one
    cin, width, out, sizes = 64, 64, 256, {}
    for stage, blocks in enumerate(RESNET_BLOCKS[depth]):
        trains = stage + 2 > freeze_at
        for b in range(blocks):
            s = 2 if b == 0 and stage > 0 else 1
            bh, bw = _conv_out(oh, 1, s), _conv_out(ow, 1, s)
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
    for level, (lh, lw, c, flows) in sizes.items():
        layers.append((f"fpn.lateral_{level}", lh * lw * FPN_CHANNELS * c, True, flows))
        layers.append((f"fpn.output_{level}", lh * lw * FPN_CHANNELS * FPN_CHANNELS * 9, True, True))
    return layers


def vit_pyramid(h: int, w: int, patch: int = 16, dim: int = 768, depth: int = 12, window: int = 14,
                global_every: int = 3, mlp_ratio: int = 4, out: int = FPN_CHANNELS,
                freeze_at: int = 0) -> List[Layer]:
    """ViT with windowed and global attention (padded windows), and the
    simple pyramid. Every layer trains (``FREEZE_AT`` 0)."""
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
    if m["BACKBONE"]["NAME"] == "build_vit_fpn_backbone":
        trunk = vit_pyramid(h, w, freeze_at=m["BACKBONE"]["FREEZE_AT"])
    else:
        trunk = resnet_fpn(h, w, m["RESNETS"]["DEPTH"], m["BACKBONE"]["FREEZE_AT"])
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
