"""Anchor generation (numpy).

Copy of ``openset_rcnn_tpu/ops/anchors.py``, so that the port imports nothing
of the JAX package.

TPU-native equivalent of detectron2's ``DefaultAnchorGenerator`` (built at
classification_free_rpn.py:289). Anchors depend only on static feature-map
shapes, so they are computed once per bucket in numpy and constant-folded
under jit (SURVEY.md §2.3 "Anchor generation"); the port builds them once per
bucket and keeps them on the device.

Both benchmark configs use a single aspect ratio [1.0] and one size per FPN
level (configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml:8), i.e. A=1, but the
general (sizes x aspect_ratios) grid is supported.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    """Zero-centered (A, 4) xyxy anchors for one level (d2 generate_cell_anchors)."""
    out = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, dtype=np.float32)


def grid_anchors(
    feat_h: int,
    feat_w: int,
    stride: int,
    sizes: Sequence[float],
    aspect_ratios: Sequence[float],
    offset: float = 0.0,
) -> np.ndarray:
    """(H*W*A, 4) anchors for one feature level, row-major over (y, x, a)."""
    base = cell_anchors(sizes, aspect_ratios)  # (A, 4)
    shifts_x = (np.arange(feat_w, dtype=np.float32) + offset) * stride
    shifts_y = (np.arange(feat_h, dtype=np.float32) + offset) * stride
    sx, sy = np.meshgrid(shifts_x, shifts_y)  # (H, W)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)  # (H*W, 1, 4)
    return (shifts + base[None, :, :]).reshape(-1, 4)


def fpn_anchors(
    image_hw: Tuple[int, int],
    strides: Sequence[int],
    sizes_per_level: Sequence[Sequence[float]],
    aspect_ratios: Sequence[float],
    offset: float = 0.0,
) -> List[np.ndarray]:
    """Per-level anchors for an image bucket padded to `image_hw`.

    Feature sizes are ceil(image / stride), matching conv padding semantics
    of the R50-FPN backbone (all sizes here are /32-divisible in practice).
    """
    h, w = image_hw
    out = []
    for stride, sizes in zip(strides, sizes_per_level):
        fh = int(math.ceil(h / stride))
        fw = int(math.ceil(w / stride))
        out.append(grid_anchors(fh, fw, stride, sizes, aspect_ratios, offset))
    return out
