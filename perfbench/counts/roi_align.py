"""Bytes that RoIAlign's kernels have to move, from the call's shapes.

Each input byte counted once and each output byte once: the forward (K1)
reads the pooled levels P2-P5 in bf16 (the whole maps: RoIs cover them) and
the boxes and levels, and writes (B, R, P, P, C) f32; the backward (K2)
reads the (B, R, P, P, C) f32 cotangent and the boxes and levels, and writes
every cell of the per-level accumulators (f32, or bf16 in the
``pallas_bf16`` mode). The bound is the bytes over the card's 3.35 TB/s;
both kernels' operations lie far below the 67 TFLOP/s f32 line.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
STRIDES = (4, 8, 16, 32)
ACC_BYTES = {"pallas": 4, "xla": 4, "pallas_bf16": 2}


def level_hw(bucket: Sequence[int]) -> List[Tuple[int, int]]:
    h, w = bucket
    return [(math.ceil(h / s), math.ceil(w / s)) for s in STRIDES]


def _rois(batch: int, rois: int) -> int:
    return batch * rois * (4 * 4 + 4)  # f32 boxes and int32 levels


def fwd_bytes(batch: int, rois: int, bucket: Sequence[int], channels: int = 256, resolution: int = 7) -> int:
    cells = sum(h * w for h, w in level_hw(bucket))
    return batch * cells * channels * 2 + batch * rois * resolution**2 * channels * 4 + _rois(batch, rois)


def bwd_bytes(batch: int, rois: int, bucket: Sequence[int], acc: str, channels: int = 256,
              resolution: int = 7) -> int:
    cells = sum(h * w for h, w in level_hw(bucket))
    return batch * rois * resolution**2 * channels * 4 + batch * cells * channels * ACC_BYTES[acc] + _rois(batch, rois)


def bound_s(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
