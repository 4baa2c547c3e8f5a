"""Box utilities (XYXY absolute coordinates throughout).

Port of ``openset_rcnn_tpu/ops/boxes.py``. Everything is fixed-shape and
batched; "removing" a box is expressed by a validity mask.
"""
from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return w * h


def clip_boxes(boxes: torch.Tensor, image_hw: torch.Tensor) -> torch.Tensor:
    """Clip (..., P, 4) boxes to [0, W] x [0, H]; image_hw is (..., 2) (h, w)."""
    h = image_hw[..., 0, None]
    w = image_hw[..., 1, None]
    x1 = torch.minimum(torch.clamp(boxes[..., 0], min=0.0), w)
    y1 = torch.minimum(torch.clamp(boxes[..., 1], min=0.0), h)
    x2 = torch.minimum(torch.clamp(boxes[..., 2], min=0.0), w)
    y2 = torch.minimum(torch.clamp(boxes[..., 3], min=0.0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Mask of boxes with both sides > threshold (d2 Boxes.nonempty)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection areas, shapes (..., M, 4) x (..., N, 4) -> (..., M, N)."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix (..., M, N). Zero where union is zero (d2 semantics)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    inter = pairwise_intersection(boxes1, boxes2)
    union = area1[..., :, None] + area2[..., None, :] - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, inter / safe, torch.zeros_like(inter))


def elementwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of aligned box pairs, shapes (..., 4) x (..., 4) -> (...)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, inter / safe, torch.zeros_like(inter))
