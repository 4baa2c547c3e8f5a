"""Classification-Free RPN: the head and proposal selection.

Port of ``openset_rcnn_tpu/models/rpn.py:43-91, 252-285``. The head is a
shared 3x3 conv + ReLU, a channel L2-normalisation (squared norm summed in
f32), then 1x1 convs for ltrb anchor deltas and sigmoid centerness. There is
no objectness classifier. Proposals are the per-level top-k by centerness,
with no NMS.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.box_transforms import Box2BoxTransformLinear
from ..ops.boxes import clip_boxes, nonempty
from ..ops.topk import stable_topk
from ..structures import Proposals


class ClsFreeRPNHead(nn.Module):
    """Per-level head, weights shared across FPN levels."""

    def __init__(self, channels: int = 256, num_anchors: int = 1, delta_bias_init: float = 0.0):
        super().__init__()
        self.delta_bias_init = delta_bias_init
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)
        self.centerness = nn.Conv2d(channels, num_anchors, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per level: deltas (B, H*W*A, 4) and centerness (B, H*W*A), f32,
        in the JAX (y, x, a) row-major anchor order."""
        deltas, ctrs = [], []
        for x in feats:
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
