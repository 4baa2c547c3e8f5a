"""Fused IoU + matcher of the RPN targets, for the reference.

Frozen copy of ``iou_match_plain`` from ``openset_rcnn_tpu_torch/ops/iou_match.py``:
per image, the best IoU of each anchor over the valid GT, the first GT that
reaches it, the low-quality rescue flag and the matched box. ``iou_match``
is the plain version.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import pairwise_iou



class IouMatch(NamedTuple):
    max_iou: torch.Tensor        # (B, R) f32
    matched_idx: torch.Tensor    # (B, R) int32
    rescued: torch.Tensor        # (B, R) bool
    matched_boxes: torch.Tensor  # (B, R, 4) f32


def iou_match_plain(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor) -> IouMatch:
    """anchors (R, 4), gt_boxes (B, G, 4), gt_valid (B, G) bool."""
    iou = pairwise_iou(gt_boxes, anchors[None])  # (B, G, R)
    masked = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
    max_iou, matched_idx = torch.max(masked, dim=1)  # first maximum wins
    best_per_gt = torch.amax(masked, dim=2, keepdim=True)
    tie = (masked == best_per_gt) & (best_per_gt > 0) & gt_valid[..., None]
    boxes = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))
    return IouMatch(max_iou, matched_idx.to(torch.int32), tie.any(dim=1), boxes)


iou_match = iou_match_plain
