"""Classification-Free RPN: the head, anchor targets, losses and proposal
selection.

Port of ``openset_rcnn_tpu/models/rpn.py:43-285``. The head is a shared 3x3
conv + ReLU, a channel L2-normalisation (squared norm summed in f32), then
1x1 convs for ltrb anchor deltas and sigmoid centerness. There is no
objectness classifier. Targets: one IoU+matcher pass (``ops/iou_match.py``,
a CUDA kernel on the GPU) feeds two matchers (box regression [0.3, 0.7],
objectness [0.1, 0.3], both with the low-quality rescue), each subsampled on
its own, and FCOS-style centerness targets. Proposals are the per-level
top-k by centerness, with no NMS.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.box_transforms import Box2BoxTransformLinear
from ..ops.boxes import clip_boxes, nonempty
from ..ops.iou_match import iou_match
from ..ops.losses import LOCAL, LocalSum, dense_box_regression_loss, masked_sum, smooth_l1
from ..ops.sampling import subsample_labels
from ..ops.targets import centerness_targets
from ..ops.topk import stable_topk
from ..structures import GroundTruth, Proposals
from .resnet import Conv2d


class ClsFreeRPNHead(nn.Module):
    """Per-level head, weights shared across FPN levels. ``compute_dtype``
    (None: the inputs' dtype) casts the inputs and runs the convs in it; the
    squared norm is summed in f32 either way."""

    def __init__(self, channels: int = 256, num_anchors: int = 1, delta_bias_init: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.delta_bias_init = delta_bias_init
        self.compute_dtype = compute_dtype
        self.conv = Conv2d(channels, channels, 3, padding=1)
        self.anchor_deltas = Conv2d(channels, num_anchors * 4, 1)
        self.centerness = Conv2d(channels, num_anchors, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per level: deltas (B, H*W*A, 4) and centerness (B, H*W*A), f32,
        in the JAX (y, x, a) row-major anchor order."""
        deltas, ctrs = [], []
        for x in feats:
            if self.compute_dtype is not None:
                x = x.to(self.compute_dtype)
            t = torch.relu(self.conv(x))
            sq = torch.sum(torch.square(t.float()), dim=1, keepdim=True)
            t = t * torch.rsqrt(sq + 1e-12).to(t.dtype)
            d = self.anchor_deltas(t)
            c = torch.sigmoid(self.centerness(t).float())
            B = d.shape[0]
            deltas.append(d.permute(0, 2, 3, 1).reshape(B, -1, 4).float())
            ctrs.append(c.permute(0, 2, 3, 1).reshape(B, -1))
        return deltas, ctrs

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal(0.01) weights; zero biases, delta bias at ``delta_bias_init``."""
        for m in (self.conv, self.anchor_deltas, self.centerness):
            nn.init.normal_(m.weight, std=0.01, generator=generator)
            nn.init.zeros_(m.bias)
        nn.init.constant_(self.anchor_deltas.bias, self.delta_bias_init)


class RPNTargets(NamedTuple):
    reg_labels: torch.Tensor     # (B, R) int32 in {-1, 0, 1} after sampling
    matched_boxes: torch.Tensor  # (B, R, 4)
    obj_labels: torch.Tensor     # (B, R) int32 in {-1, 0, 1} after sampling
    gt_centerness: torch.Tensor  # (B, R)


def _bin_labels(max_iou: torch.Tensor, rescued: torch.Tensor, thresholds: Sequence[float]) -> torch.Tensor:
    """3-bin matcher labels {0, -1, 1} from the fused matcher's outputs
    (``ops/matcher.py::match`` with labels [0, -1, 1] and the rescue; images
    without GT fall out as all 0 because their max_iou is -1)."""
    out = torch.zeros(max_iou.shape, dtype=torch.int32, device=max_iou.device)
    out = torch.where(max_iou >= thresholds[0], torch.full_like(out, -1), out)
    out = torch.where(max_iou >= thresholds[1], torch.ones_like(out), out)
    return torch.where(rescued, torch.ones_like(out), out)


def rpn_targets(
    anchors: torch.Tensor,
    gt: GroundTruth,
    batch_size_per_image: int = 256,
    positive_fraction: float = 0.5,
    objectness_positive_fraction: float = 1.0,
    reg_thresholds: Sequence[float] = (0.3, 0.7),
    obj_thresholds: Sequence[float] = (0.1, 0.3),
    *,
    uniforms: torch.Tensor,
) -> RPNTargets:
    """Anchor targets for (R, 4) anchors and padded GT.

    ``uniforms`` (B, 2, 2, R): the sampling draws per image, [regression,
    objectness] x [positives, negatives] (the JAX key tree per image:
    split -> (k_reg, k_obj), each split -> (kp, kn)).
    """
    m = iou_match(anchors, gt.boxes, gt.valid)
    reg_labels = subsample_labels(_bin_labels(m.max_iou, m.rescued, reg_thresholds),
                                  batch_size_per_image, positive_fraction, uniforms=uniforms[:, 0])
    obj_labels = subsample_labels(_bin_labels(m.max_iou, m.rescued, obj_thresholds),
                                  batch_size_per_image, objectness_positive_fraction, uniforms=uniforms[:, 1])
    gt_ctr = centerness_targets(anchors[None], m.matched_boxes, obj_labels)
    return RPNTargets(reg_labels, m.matched_boxes, obj_labels, gt_ctr)


def rpn_losses(
    anchors: torch.Tensor,
    pred_deltas: torch.Tensor,      # (B, R, 4)
    pred_centerness: torch.Tensor,  # (B, R)
    targets: RPNTargets,
    transform: Box2BoxTransformLinear,
    batch_size_per_image: int = 256,
    loc_weight: float = 1.0,
    ctr_weight: float = 1.0,
    box_reg_loss_type: str = "iou",
    ctr_smooth_l1_beta: float = 0.0,
    global_sum: LocalSum = LOCAL,
) -> Dict[str, torch.Tensor]:
    """IoU-family loss on sampled positives + L1 centerness on sampled
    positives and negatives, both over (batch_size_per_image * B), B the
    global batch: this rank's images times ``global_sum.size``."""
    pos = targets.reg_labels == 1
    if box_reg_loss_type in ("iou", "giou", "diou", "ciou"):
        pred_boxes = transform.apply_deltas(pred_deltas, anchors[None])
        loc_loss = dense_box_regression_loss(pred_boxes, targets.matched_boxes, pos, box_reg_loss_type)
    elif box_reg_loss_type == "smooth_l1":
        gt_deltas = transform.get_deltas(anchors[None], targets.matched_boxes)
        loc_loss = masked_sum(smooth_l1(pred_deltas, gt_deltas, 0.0), pos)
    else:
        raise ValueError(box_reg_loss_type)
    ctr_loss = masked_sum(smooth_l1(pred_centerness, targets.gt_centerness, ctr_smooth_l1_beta),
                          targets.obj_labels != -1)
    normalizer = batch_size_per_image * pred_deltas.shape[0] * global_sum.size
    return {
        "loss_rpn_loc": loc_weight * loc_loss / normalizer,
        "loss_rpn_ctr": ctr_weight * ctr_loss / normalizer,
    }


def select_proposals(
    anchors: torch.Tensor,          # (R, 4) concatenated over levels
    pred_deltas: torch.Tensor,      # (B, R, 4)
    pred_centerness: torch.Tensor,  # (B, R)
    level_sizes: Sequence[int],
    image_hw: torch.Tensor,         # (B, 2) actual (h, w)
    transform: Box2BoxTransformLinear,
    pre_topk: int,
    min_box_size: float = 0.0,
) -> Proposals:
    """Per-level top-k by centerness (ties: lower anchor index first); no NMS."""
    boxes = transform.apply_deltas(pred_deltas, anchors[None])  # (B, R, 4)
    sel_boxes, sel_scores = [], []
    start = 0
    for n in level_sizes:
        top_s, top_i = stable_topk(pred_centerness[:, start : start + n], min(pre_topk, n))
        level_boxes = boxes[:, start : start + n]
        sel_boxes.append(torch.gather(level_boxes, 1, top_i[..., None].expand(-1, -1, 4)))
        sel_scores.append(top_s)
        start += n
    out_boxes = clip_boxes(torch.cat(sel_boxes, dim=1), image_hw)
    out_scores = torch.cat(sel_scores, dim=1)
    finite = torch.all(torch.isfinite(out_boxes), dim=-1) & torch.isfinite(out_scores)
    valid = finite & nonempty(out_boxes, min_box_size)
    return Proposals(
        boxes=out_boxes, scores=torch.where(valid, out_scores, torch.zeros_like(out_scores)), valid=valid
    )
