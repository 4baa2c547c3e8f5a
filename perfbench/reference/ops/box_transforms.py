"""Box parameterizations.

Port of ``openset_rcnn_tpu/ops/box_transforms.py``: detectron2's
``Box2BoxTransform`` (xywh deltas, weights (10,10,5,5); the ROI box predictor)
and ``Box2BoxTransformLinear`` with ``normalize_by_size=True`` (ltrb distances;
CF-RPN). Shape-polymorphic over leading dims; boxes are xyxy.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

# Maximum log-space delta (d2 _DEFAULT_SCALE_CLAMP = log(1000/16)).
SCALE_CLAMP = math.log(1000.0 / 16.0)


def _ctr_wh(boxes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return cx, cy, w, h


class Box2BoxTransform:
    """Scale-invariant (dx, dy, dw, dh) deltas between source and target boxes."""

    def __init__(self, weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0)):
        self.weights = tuple(float(w) for w in weights)

    def get_deltas(self, src: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        scx, scy, sw, sh = _ctr_wh(src)
        tcx, tcy, tw, th = _ctr_wh(target)
        wx, wy, ww, wh = self.weights
        dx = wx * (tcx - scx) / sw
        dy = wy * (tcy - scy) / sh
        dw = ww * torch.log(tw / sw)
        dh = wh * torch.log(th / sh)
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        scx, scy, sw, sh = _ctr_wh(boxes)
        wx, wy, ww, wh = self.weights
        dx = deltas[..., 0] / wx
        dy = deltas[..., 1] / wy
        dw = torch.clamp(deltas[..., 2] / ww, max=SCALE_CLAMP)
        dh = torch.clamp(deltas[..., 3] / wh, max=SCALE_CLAMP)
        pcx = dx * sw + scx
        pcy = dy * sh + scy
        pw = torch.exp(dw) * sw
        ph = torch.exp(dh) * sh
        return torch.stack(
            [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1
        )


class Box2BoxTransformLinear:
    """(l, t, r, b) distances from source-box center to target-box sides.

    With ``normalize_by_size`` the distances are divided by the source box's
    width/height, the parameterization CF-RPN regresses.
    """

    def __init__(self, normalize_by_size: bool = True):
        self.normalize_by_size = normalize_by_size

    def get_deltas(self, src: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        scx, scy, sw, sh = _ctr_wh(src)
        l = scx - target[..., 0]
        t = scy - target[..., 1]
        r = target[..., 2] - scx
        b = target[..., 3] - scy
        deltas = torch.stack([l, t, r, b], dim=-1)
        if self.normalize_by_size:
            deltas = deltas / torch.stack([sw, sh, sw, sh], dim=-1)
        return deltas

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        # d2 clamps predicted distances at >= 0 (boxes cannot invert).
        deltas = torch.clamp(deltas, min=0.0)
        scx, scy, sw, sh = _ctr_wh(boxes)
        if self.normalize_by_size:
            deltas = deltas * torch.stack([sw, sh, sw, sh], dim=-1)
        x1 = scx - deltas[..., 0]
        y1 = scy - deltas[..., 1]
        x2 = scx + deltas[..., 2]
        y2 = scy + deltas[..., 3]
        return torch.stack([x1, y1, x2, y2], dim=-1)
