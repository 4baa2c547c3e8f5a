"""Training targets of the CF-RPN: centerness.

Port of ``openset_rcnn_tpu/ops/targets.py:15-41``: from each anchor's center,
the (l, r, t, b) distances to the sides of its matched GT box give
centerness = sqrt(min(l,r)/max(l,r) * min(t,b)/max(t,b)); zero when the
center lies outside the box or the anchor is a sampled negative.
"""
from __future__ import annotations

import torch


def centerness_targets(
    anchors: torch.Tensor,
    matched_gt: torch.Tensor,
    objectness_labels: torch.Tensor,
    eps: float = 1e-12,
) -> torch.Tensor:
    """anchors (..., N, 4), matched_gt (..., N, 4) xyxy, objectness_labels
    (..., N) in {-1, 0, 1}; returns (..., N) centerness in [0, 1]."""
    cx = 0.5 * (anchors[..., 0] + anchors[..., 2])
    cy = 0.5 * (anchors[..., 1] + anchors[..., 3])
    l = cx - matched_gt[..., 0]
    r = matched_gt[..., 2] - cx
    t = cy - matched_gt[..., 1]
    b = matched_gt[..., 3] - cy
    inside = (l >= 0) & (r >= 0) & (t >= 0) & (b >= 0)
    zero = torch.zeros_like(l)
    l, r, t, b = (torch.where(inside, v, zero) for v in (l, r, t, b))
    lr_ratio = torch.minimum(l, r) / (torch.maximum(l, r) + eps)
    tb_ratio = torch.minimum(t, b) / (torch.maximum(t, b) + eps)
    ctr = torch.sqrt(torch.clamp(lr_ratio * tb_ratio, min=0.0))
    return torch.where(objectness_labels == 0, zero, ctr)
