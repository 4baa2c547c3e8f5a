"""Masked fixed-shape greedy NMS, batched over images, for the reference.

Frozen copy of ``openset_rcnn_tpu_torch/ops/nms.py`` without the kernel
wrapper: ``nms_keep_plain`` (the greedy scan with the exact IoU expression
and strict ``>``) is the keep function of ``nms_mask`` and
``batched_nms_mask``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


KeepFn = Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]


class NMSResult(NamedTuple):
    order: torch.Tensor  # (B, N) int64 indices sorting inputs by descending score
    keep: torch.Tensor   # (B, N) bool keep mask *in sorted order*


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Keep mask (B, N) over score-sorted (B, N, 4) boxes; see the module docstring."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    # row i = box i against every box j
    iw = torch.clamp(
        torch.minimum(x2[:, :, None], x2[:, None, :]) - torch.maximum(x1[:, :, None], x1[:, None, :]),
        min=0.0,
    )
    ih = torch.clamp(
        torch.minimum(y2[:, :, None], y2[:, None, :]) - torch.maximum(y1[:, :, None], y1[:, None, :]),
        min=0.0,
    )
    inter = iw * ih
    union = area[:, :, None] + area[:, None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros_like(inter))
    n = boxes.shape[1]
    later = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    hit = (iou > thresh) & later
    suppressed = ~valid
    keep = torch.zeros_like(valid)
    for i in range(n):
        alive = ~suppressed[:, i]
        keep[:, i] = alive
        suppressed |= alive[:, None] & hit[:, i]
    return keep


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    keep_fn: KeepFn = nms_keep_plain,
) -> NMSResult:
    """Greedy NMS over (B, N) boxes. Invalid boxes are never kept and never
    suppress. Suppression is strict '>': at iou_threshold=1.0 NMS keeps every
    valid box that is not an exact duplicate."""
    s = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(-s, dim=-1, stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    v = torch.gather(valid, 1, order).contiguous()
    return NMSResult(order=order, keep=keep_fn(b, v, iou_threshold))


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    keep_fn: KeepFn = nms_keep_plain,
) -> NMSResult:
    """Class-aware NMS via the coordinate-offset trick (d2 batched_nms)."""
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.amax(dim=(1, 2)) + 1.0
    offsets = class_ids.to(boxes.dtype)[..., None] * max_coord[:, None, None]
    return nms_mask(boxes + offsets, scores, valid, iou_threshold, keep_fn)
