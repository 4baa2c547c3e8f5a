"""IoU-threshold matcher (vectorized, fixed-shape).

Port of ``openset_rcnn_tpu/ops/matcher.py:19-70``: d2's ``Matcher`` over a
padded (G, N) IoU matrix with a GT validity mask; invalid rows never win a
match. Leading batch dims are allowed: ``iou`` (..., G, N), ``gt_valid``
(..., G).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class MatchResult(NamedTuple):
    matched_idx: torch.Tensor  # (..., N) int64 index into GT rows (0 if no GT)
    labels: torch.Tensor       # (..., N) int32 in {-1, 0, 1}


def match(
    iou: torch.Tensor,
    gt_valid: torch.Tensor,
    thresholds: Sequence[float],
    labels: Sequence[int],
    allow_low_quality_matches: bool,
) -> MatchResult:
    """Assign each of N candidates to one of G (padded) GT boxes.

    ``thresholds`` ascend (e.g. [0.3, 0.7]); ``labels`` has one more entry,
    lowest bin first (e.g. [0, -1, 1]). With zero valid GT every label is the
    lowest bin's (d2's empty-GT path). The low-quality rescue marks the
    candidates that tie a valid GT's best IoU, only when that best is > 0, so
    a degenerate GT cannot mark every candidate positive.
    """
    masked = torch.where(gt_valid[..., :, None], iou, torch.full_like(iou, -1.0))
    matched_vals, matched_idx = torch.max(masked, dim=-2)  # first maximum wins
    out = torch.full(matched_vals.shape, labels[0], dtype=torch.int32, device=iou.device)
    for lo, lab in zip(thresholds, labels[1:]):
        out = torch.where(matched_vals >= lo, torch.full_like(out, lab), out)
    if allow_low_quality_matches:
        best_per_gt = torch.amax(masked, dim=-1, keepdim=True)
        tie = (masked == best_per_gt) & (best_per_gt > 0) & gt_valid[..., :, None]
        out = torch.where(tie.any(dim=-2), torch.ones_like(out), out)
    any_gt = gt_valid.any(dim=-1, keepdim=True)
    out = torch.where(any_gt, out, torch.full_like(out, labels[0]))
    return MatchResult(matched_idx=matched_idx, labels=out)
