"""Fused IoU + matcher for RPN targets: plain version and kernel wrapper.

Port of the TPU kernel ``iou_match_pallas``
(``openset_rcnn_tpu/ops/pallas/iou_match_kernel.py:30-140``) and of the XLA
fallback it replaces (``openset_rcnn_tpu/models/rpn.py:111-119`` plus the
``gt_boxes[matched_idx]`` gather). Per image, for R anchors (shared by the
batch) against G padded GT boxes:

* ``max_iou`` (B, R) f32: best IoU over the valid GT, -1 with no valid GT;
* ``matched_idx`` (B, R) int32: the first GT that reaches it (0 if none);
* ``rescued`` (B, R) bool: the anchor ties some valid GT's best IoU and that
  best is > 0 (the low-quality rescue of ``ops/matcher.py``);
* ``matched_boxes`` (B, R, 4) f32: that GT's box, GT row 0 when nothing
  matched.

``iou_match_plain`` forms the (B, G, R) IoU matrix in PyTorch; it is the CPU
path and the kernel's oracle. ``iou_match`` is the wrapper: the plain version
for CPU tensors, the CUDA kernel (``csrc/iou_match.cu``: two launches that
never form the matrix, and no other device operation) for CUDA tensors.
There is no fallback. Both compute the IoU with
``ops/boxes.py::pairwise_iou``'s expression, operation for operation, so the
kernel's outputs equal the plain version's exactly.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .boxes import pairwise_iou

MAX_GT = 1024  # csrc/iou_match.cu kMaxGt: the GT rows one block stages in shared memory
CHUNK = 1024   # csrc/iou_match.cu kChunk: anchors a block takes per step (sizes the scratch)


class IouMatch(NamedTuple):
    max_iou: torch.Tensor        # (B, R) f32
    matched_idx: torch.Tensor    # (B, R) int32
    rescued: torch.Tensor        # (B, R) bool
    matched_boxes: torch.Tensor  # (B, R, 4) f32


def iou_match_plain(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor) -> IouMatch:
    """anchors (R, 4), gt_boxes (B, G, 4), gt_valid (B, G) bool."""
    iou = pairwise_iou(gt_boxes, anchors[None])  # (B, G, R)
    masked = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
    max_iou, matched_idx = torch.max(masked, dim=1)  # first maximum wins
    best_per_gt = torch.amax(masked, dim=2, keepdim=True)
    tie = (masked == best_per_gt) & (best_per_gt > 0) & gt_valid[..., None]
    boxes = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))
    return IouMatch(max_iou, matched_idx.to(torch.int32), tie.any(dim=1), boxes)


_SIGNATURE = {
    "iou_match": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6,
}


def iou_match(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor) -> IouMatch:
    """See the module docstring. CPU tensors take the plain version; CUDA
    tensors launch the kernel's two passes (counted as two launches), the
    call's only device operations."""
    if anchors.device.type == "cpu":
        return iou_match_plain(anchors, gt_boxes, gt_valid)
    if anchors.device.type != "cuda":
        raise ValueError(f"iou_match runs on CPU or CUDA tensors, not {anchors.device}")
    if anchors.dtype != torch.float32 or anchors.dim() != 2 or anchors.shape[1] != 4:
        raise ValueError(f"anchors must be (R, 4) float32, got {tuple(anchors.shape)} {anchors.dtype}")
    if gt_boxes.dtype != torch.float32 or gt_boxes.dim() != 3 or gt_boxes.shape[2] != 4:
        raise ValueError(f"gt_boxes must be (B, G, 4) float32, got {tuple(gt_boxes.shape)} {gt_boxes.dtype}")
    B, G = gt_boxes.shape[:2]
    R = anchors.shape[0]
    if gt_valid.dtype != torch.bool or tuple(gt_valid.shape) != (B, G):
        raise ValueError(f"gt_valid must be ({B}, {G}) bool, got {tuple(gt_valid.shape)} {gt_valid.dtype}")
    for x in (anchors, gt_boxes, gt_valid):
        if x.device != anchors.device or not x.is_contiguous():
            raise ValueError("anchors, gt_boxes and gt_valid must be contiguous and on one device")
    if not 1 <= G <= MAX_GT:
        raise ValueError(f"the kernel takes 1 to {MAX_GT} (padded) GT rows per image, got {G}")
    if anchors.data_ptr() % 16:
        raise ValueError("anchors must be 16-byte aligned (one float4 per anchor)")
    dev = anchors.device
    out = IouMatch(
        torch.empty((B, R), dtype=torch.float32, device=dev),
        torch.empty((B, R), dtype=torch.int32, device=dev),
        torch.empty((B, R), dtype=torch.bool, device=dev),
        torch.empty((B, R, 4), dtype=torch.float32, device=dev),
    )
    if B * R == 0:
        return out
    # each block's per-GT maxima; the kernels write and read them, nothing is filled
    partial = torch.empty((B, -(-R // CHUNK), G), dtype=torch.float32, device=dev)
    lib = _build.load("iou_match", _SIGNATURE)
    with torch.cuda.device(dev):
        code = lib.iou_match(
            anchors.data_ptr(), gt_boxes.data_ptr(), gt_valid.data_ptr(), B, G, R,
            partial.data_ptr(), *(t.data_ptr() for t in out), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, "iou_match", code)
    iou_match.launches += 2
    return out


iou_match.launches = 0  # kernel launches since the last reset
