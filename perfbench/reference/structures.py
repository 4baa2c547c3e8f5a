"""Fixed-shape batched containers of tensors.

Port of ``openset_rcnn_tpu/structures.py:14-71``: the batch dimension leads
everywhere and absent entries are expressed with validity masks, so every
function sees static shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class GroundTruth:
    """Padded GT annotations for a batch of images."""

    boxes: torch.Tensor    # (B, G, 4) xyxy in network-input coordinates
    classes: torch.Tensor  # (B, G) int contiguous category ids
    valid: torch.Tensor    # (B, G) bool


@dataclass(frozen=True)
class ImageBatch:
    """A padded batch ready for the device."""

    images: torch.Tensor    # (B, H, W, 3) raw BGR pixel values
    image_hw: torch.Tensor  # (B, 2) float32 actual (h, w) before padding
    gt: Optional[GroundTruth] = None


@dataclass(frozen=True)
class Proposals:
    """Fixed-size per-image proposal sets."""

    boxes: torch.Tensor   # (B, P, 4)
    scores: torch.Tensor  # (B, P) centerness-derived objectness in [0, 1]
    valid: torch.Tensor   # (B, P) bool


@dataclass(frozen=True)
class SampledRois:
    """ROI-head training samples."""

    boxes: torch.Tensor       # (B, S, 4) proposal boxes
    scores: torch.Tensor      # (B, S) proposal objectness (centerness)
    gt_boxes: torch.Tensor    # (B, S, 4) matched GT box
    gt_classes: torch.Tensor  # (B, S) int; num_classes = background
    ious: torch.Tensor        # (B, S) matched IoU (the IoU-regression target)
    is_fg: torch.Tensor       # (B, S) bool
    valid: torch.Tensor       # (B, S) bool


@dataclass(frozen=True)
class RawDetections:
    """Per-proposal raw outputs of the heads, before the open-set cascade."""

    boxes: torch.Tensor        # (B, P, 4) regressed, clipped to input size
    objectness: torch.Tensor   # (B, P) sqrt(iou * centerness)
    pred_iou: torch.Tensor     # (B, P)
    centerness: torch.Tensor   # (B, P)
    min_dist: torch.Tensor     # (B, P) min prototype distance
    pln_class: torch.Tensor    # (B, P) int64 argmin known class index
    known_probs: torch.Tensor  # (B, P, K+1) softmax over known classes + bg
    valid: torch.Tensor        # (B, P) bool
