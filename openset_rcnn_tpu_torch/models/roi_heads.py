"""Open-set ROI heads: RoI pooling, the four heads and raw detections.

Port of ``openset_rcnn_tpu/models/roi_heads.py:45-114, 300-382``:
  * ``BoxHead``: flatten + 2x FC-1024 + ReLU;
  * ``BoxIouPredictor``: class-agnostic box deltas + sigmoid IoU;
  * ``PLNHead``: encoder/decoder 1024<->256 and learnable prototypes;
  * ``KnownClassifier``: (K+1)-way linear classifier on reconstructed features;
  * ``pool_features``: RoIAlignV2 7x7 over P2-P5 in bf16, returned in f32;
  * ``raw_detections``: box decoding, objectness, prototype distances, softmax.

Layout: pooled features are (B, S, 7, 7, C), the JAX flatten order, so
``fc1``'s weight is the JAX kernel transposed, with no row permutation.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..ops.box_transforms import Box2BoxTransform
from ..ops.boxes import clip_boxes
from ..ops.roi_align import assign_levels, roi_align
from ..structures import Proposals, RawDetections


def _dense_init(layer: nn.Linear, std: float, generator: torch.Generator) -> None:
    nn.init.normal_(layer.weight, std=std, generator=generator)
    nn.init.zeros_(layer.bias)


class BoxHead(nn.Module):
    """FastRCNNConvFCHead equivalent: flatten + 2x FC + ReLU (f32)."""

    def __init__(self, in_dim: int, fc_dim: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(*x.shape[:-3], -1)
        return torch.relu(self.fc2(torch.relu(self.fc1(x))))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Caffe2 Xavier (uniform, fan_in) weights, zero biases."""
        for fc in (self.fc1, self.fc2):
            bound = math.sqrt(3.0 / fc.in_features)
            nn.init.uniform_(fc.weight, -bound, bound, generator=generator)
            nn.init.zeros_(fc.bias)


class BoxIouPredictor(nn.Module):
    """Class-agnostic box deltas + sigmoid IoU prediction."""

    def __init__(self, in_dim: int = 1024):
        super().__init__()
        self.bbox_pred = nn.Linear(in_dim, 4)
        self.iou_pred = nn.Linear(in_dim, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.bbox_pred(x), torch.sigmoid(self.iou_pred(x))[..., 0]

    def reset_parameters(self, generator: torch.Generator) -> None:
        _dense_init(self.bbox_pred, 0.001, generator)
        _dense_init(self.iou_pred, 0.01, generator)


class PLNHead(nn.Module):
    """Prototype Learning Network: encoder/decoder + learnable prototypes."""

    def __init__(self, feature_dim: int = 1024, embedding_dim: int = 256,
                 num_known_classes: int = 20, reps_per_class: int = 1):
        super().__init__()
        self.encoder = nn.Linear(feature_dim, embedding_dim)
        self.decoder = nn.Linear(embedding_dim, feature_dim)
        self.representatives = nn.Parameter(torch.empty(num_known_classes * reps_per_class, embedding_dim))

    def forward(self, x: torch.Tensor):
        emb = self.encoder(x)
        return emb, self.decoder(emb), self.representatives

    def reset_parameters(self, generator: torch.Generator) -> None:
        _dense_init(self.encoder, 0.01, generator)
        _dense_init(self.decoder, 0.01, generator)
        nn.init.normal_(self.representatives, std=1.0, generator=generator)


class KnownClassifier(nn.Module):
    """(K_known + 1)-way linear classifier over reconstructed features."""

    def __init__(self, in_dim: int = 1024, num_known_classes: int = 20):
        super().__init__()
        self.cls_score = nn.Linear(in_dim, num_known_classes + 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cls_score(x)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _dense_init(self.cls_score, 0.01, generator)


def pool_features(
    fpn_feats: Dict[str, torch.Tensor],
    boxes: torch.Tensor,  # (B, S, 4)
    in_features: Sequence[str] = ("p2", "p3", "p4", "p5"),
    strides: Sequence[int] = (4, 8, 16, 32),
    resolution: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """(B, S, P, P, C) f32 RoI features. P2-P5 are cast to bf16 whatever the
    compute dtype (the JAX pooling dtype); on the GPU the channels_last NCHW
    maps are NHWC-contiguous already, so the permute below copies nothing."""
    feats = [fpn_feats[f].to(torch.bfloat16).permute(0, 2, 3, 1).contiguous() for f in in_features]
    levels = assign_levels(boxes, min_level=2, max_level=2 + len(feats) - 1)
    return roi_align(feats, boxes, levels, strides, resolution, sampling_ratio)


def raw_detections(
    proposals: Proposals,
    pred_deltas: torch.Tensor,
    pred_iou: torch.Tensor,
    emb: torch.Tensor,
    reps: torch.Tensor,
    known_logits: torch.Tensor,
    image_hw: torch.Tensor,
    transform: Box2BoxTransform,
    num_known_classes: int,
    reps_per_class: int,
    mean_type: str = "geometric",
    distance_type: str = "COS",
) -> RawDetections:
    boxes = clip_boxes(transform.apply_deltas(pred_deltas, proposals.boxes), image_hw)
    if mean_type == "geometric":
        objectness = torch.sqrt(torch.clamp(pred_iou * proposals.scores, min=0.0))
    else:
        objectness = 0.5 * (pred_iou + proposals.scores)

    B, P, E = emb.shape
    x = emb.reshape(B * P, E)
    x = x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + 1e-12)
    r = reps * torch.rsqrt(torch.sum(reps * reps, -1, keepdim=True) + 1e-12)
    if distance_type == "COS":
        dist = 1.0 - x @ r.T
    elif distance_type == "L2":
        dist = torch.sqrt(torch.clamp(torch.sum((x[:, None] - r[None]) ** 2, -1), min=1e-12))
    else:
        dist = torch.sum(torch.abs(x[:, None] - r[None]), -1)
    per_class = torch.amin(dist.reshape(B, P, num_known_classes, reps_per_class), dim=3)
    min_dist, pln_class = torch.min(per_class, dim=2)
    return RawDetections(
        boxes=boxes,
        objectness=objectness,
        pred_iou=pred_iou,
        centerness=proposals.scores,
        min_dist=min_dist,
        pln_class=pln_class,
        known_probs=torch.softmax(known_logits, dim=-1),
        valid=proposals.valid,
    )
