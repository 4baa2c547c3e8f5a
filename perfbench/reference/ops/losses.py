"""Loss primitives: masked, fixed-shape.

Port of ``openset_rcnn_tpu/ops/losses.py:17-131``: fvcore's smooth-L1 and
the reference's IoU-family box-regression losses as masked reductions, so
padded rows contribute exactly zero. Reductions that are differentiated use
``torch.amax``/``amin``, which share the gradient among ties as JAX's do.

Global batch: the JAX package's losses are values over the global batch
(GSPMD sums every ``sum(valid)`` over all devices). A data-parallel rank sees
only its own rows, so each loss denominator goes through a ``global_sum``
hook: ``LOCAL`` (one process, the batch is the global batch) or
``parallel.mesh.GroupSum`` (the sum over the data group). Numerators stay
local, and the ranks' losses add up to the global loss.
"""
from __future__ import annotations

import math

import torch

from .boxes import elementwise_iou


class LocalSum:
    """The ``global_sum`` hook of one process: the identity, over a data
    group of ``size`` 1."""

    size = 1

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


LOCAL = LocalSum()


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Elementwise smooth-L1; beta=0 reduces to pure L1 (fvcore semantics)."""
    diff = torch.abs(pred - target)
    if beta <= 0.0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def masked_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum of values where mask (broadcast over trailing dims of values)."""
    if values.dim() > mask.dim():
        mask = mask[..., None]
    return torch.sum(torch.where(mask, values, torch.zeros_like(values)))


def _safe(x: torch.Tensor) -> torch.Tensor:
    """x where x > 0, else 1 (a denominator that cannot be zero)."""
    return torch.where(x > 0, x, torch.ones_like(x))


def iou_box_loss(pred_boxes, gt_boxes, fg_mask) -> torch.Tensor:
    """Masked sum of 1 - IoU, IoU clipped at >= 1e-6 (the reference's "iou"
    branch, used by the RPN loc loss and the ROI box head)."""
    ious = torch.clamp(elementwise_iou(pred_boxes, gt_boxes), min=1e-6)
    return masked_sum(1.0 - ious, fg_mask)


def _box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _enclosing_wh(pred_boxes, gt_boxes) -> torch.Tensor:
    lt = torch.minimum(pred_boxes[..., :2], gt_boxes[..., :2])
    rb = torch.maximum(pred_boxes[..., 2:], gt_boxes[..., 2:])
    return torch.clamp(rb - lt, min=0.0)


def giou_box_loss(pred_boxes, gt_boxes, fg_mask) -> torch.Tensor:
    """Masked sum GIoU loss."""
    iou = elementwise_iou(pred_boxes, gt_boxes)
    wh = _enclosing_wh(pred_boxes, gt_boxes)
    enclose = wh[..., 0] * wh[..., 1]
    areas = _box_area(pred_boxes) + _box_area(gt_boxes)
    inter = iou * _safe(areas) / _safe(1 + iou)  # union recomputed from the areas
    union = areas - inter
    giou = iou - (enclose - union) / _safe(enclose)
    return masked_sum(1.0 - giou, fg_mask)


def _center_dist2_and_diag2(pred_boxes, gt_boxes):
    px = 0.5 * (pred_boxes[..., 0] + pred_boxes[..., 2])
    py = 0.5 * (pred_boxes[..., 1] + pred_boxes[..., 3])
    gx = 0.5 * (gt_boxes[..., 0] + gt_boxes[..., 2])
    gy = 0.5 * (gt_boxes[..., 1] + gt_boxes[..., 3])
    d2 = (px - gx) ** 2 + (py - gy) ** 2
    wh = _enclosing_wh(pred_boxes, gt_boxes)
    return d2, wh[..., 0] ** 2 + wh[..., 1] ** 2


def diou_box_loss(pred_boxes, gt_boxes, fg_mask) -> torch.Tensor:
    """Masked sum Distance-IoU loss."""
    iou = elementwise_iou(pred_boxes, gt_boxes)
    d2, c2 = _center_dist2_and_diag2(pred_boxes, gt_boxes)
    return masked_sum(1.0 - (iou - d2 / _safe(c2)), fg_mask)


def ciou_box_loss(pred_boxes, gt_boxes, fg_mask) -> torch.Tensor:
    """Masked sum Complete-IoU loss: DIoU + an aspect-ratio term whose weight
    alpha takes no gradient (the JAX ``stop_gradient``)."""
    iou = elementwise_iou(pred_boxes, gt_boxes)
    d2, c2 = _center_dist2_and_diag2(pred_boxes, gt_boxes)
    pw = torch.clamp(pred_boxes[..., 2] - pred_boxes[..., 0], min=1e-9)
    ph = torch.clamp(pred_boxes[..., 3] - pred_boxes[..., 1], min=1e-9)
    gw = torch.clamp(gt_boxes[..., 2] - gt_boxes[..., 0], min=1e-9)
    gh = torch.clamp(gt_boxes[..., 3] - gt_boxes[..., 1], min=1e-9)
    v = (4.0 / math.pi**2) * (torch.atan(gw / gh) - torch.atan(pw / ph)) ** 2
    alpha = (v / _safe(1.0 - iou + v)).detach()
    ciou = iou - d2 / _safe(c2) - alpha * v
    return masked_sum(1.0 - ciou, fg_mask)


_DENSE_LOSSES = {"iou": iou_box_loss, "giou": giou_box_loss, "diou": diou_box_loss, "ciou": ciou_box_loss}


def dense_box_regression_loss(pred_boxes, gt_boxes, fg_mask, loss_type: str = "iou") -> torch.Tensor:
    """The reference's IoU-family loss types (smooth_l1 is handled by the
    callers, which work in delta space)."""
    if loss_type not in _DENSE_LOSSES:
        raise ValueError(f"Invalid dense box regression loss type '{loss_type}'")
    return _DENSE_LOSSES[loss_type](pred_boxes, gt_boxes, fg_mask)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                          global_sum: LocalSum = LOCAL) -> torch.Tensor:
    """Mean cross-entropy over valid rows (torch ``cross_entropy(reduction=
    'mean')``), written as the JAX version computes it; the mean is over the
    global batch's valid rows (``global_sum``)."""
    zmax = torch.amax(logits, dim=-1)
    lse = torch.log(torch.sum(torch.exp(logits - zmax[..., None]), dim=-1)) + zmax
    nll = lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]
    denom = torch.clamp(global_sum(valid.sum()), min=1)
    return torch.sum(torch.where(valid, nll, torch.zeros_like(nll))) / denom
