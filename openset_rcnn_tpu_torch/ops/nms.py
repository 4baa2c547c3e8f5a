"""Masked fixed-shape greedy NMS, batched over images.

Port of ``openset_rcnn_tpu/ops/nms.py:26-96``: sort by score, then a greedy
keep mask over the sorted order. The result is the sort permutation plus the
keep mask in sorted order; nothing is filtered dynamically.

* ``nms_keep_plain`` is the greedy scan in PyTorch, with the exact IoU
  expression and strict ``>`` of the TPU kernel
  (``openset_rcnn_tpu/ops/pallas/nms_kernel.py:45-51``). The CPU path and the
  kernel's oracle.
* ``nms_keep`` is the wrapper: plain version for CPU tensors, the CUDA kernel
  (``csrc/nms_keep.cu``: an IoU bitmask pass, then the greedy walk, both for
  all images) for CUDA tensors. There is no fallback. It goes through the
  PyTorch operator ``openset_rcnn::nms_keep`` (``nms_keep_op``: CPU and CUDA
  implementations and a fake one for tracing), so ``torch.export`` records
  K4 as one node, not the plain version's unrolled scan, and a loaded
  exported program launches the kernel as eager code does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import _native
from ..utils import tracing

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


# K4 as a PyTorch operator, ``torch.ops.openset_rcnn.nms_keep``, registered as
# ops/roi_align.py registers K1 (see there): the plain version for CPU
# tensors, the launch code for CUDA tensors, shapes only for tracing.
OPS = torch.library.Library("openset_rcnn", "FRAGMENT")
OPS.define("nms_keep(Tensor boxes, Tensor valid, float thresh) -> Tensor")


def _nms_keep_cuda(boxes, valid, thresh):
    """The CUDA implementation: launches the kernel's two passes or raises."""
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, N, 4) float32, got {tuple(boxes.shape)} {boxes.dtype}")
    B, N = boxes.shape[:2]
    if valid.dtype != torch.bool or tuple(valid.shape) != (B, N):
        raise ValueError(f"valid must be ({B}, {N}) bool, got {tuple(valid.shape)} {valid.dtype}")
    if valid.device != boxes.device or not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous and on one device")
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes.device)
    if B * N == 0:
        return keep
    lib = _native.load("nms_keep")
    if N > lib.nms_max_boxes():
        raise ValueError(f"the kernel takes at most {lib.nms_max_boxes()} boxes per image, got {N}")
    nw = -(-N // 64)  # the suppression mask's 64-bit words per row; the kernel writes what it reads
    mask = torch.empty((B, nw, 64 * nw), dtype=torch.int64, device=boxes.device)
    with torch.cuda.device(boxes.device):
        code = lib.nms_keep(
            boxes.data_ptr(), valid.data_ptr(), B, N, float(thresh), mask.data_ptr(), keep.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(lib, "nms_keep", code)
    tracing.count("kernel.nms_keep")
    return keep


def _nms_keep_fake(boxes, valid, thresh):
    """Shape and dtype only, for tracing (``torch.export``): no data, no
    launch, no count."""
    return torch.empty_like(valid)


OPS.impl("nms_keep", nms_keep_plain, "CPU")
OPS.impl("nms_keep", _nms_keep_cuda, "CUDA")
torch.library.register_fake("openset_rcnn::nms_keep", _nms_keep_fake, lib=OPS)
nms_keep_op = torch.ops.openset_rcnn.nms_keep.default


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy keep mask (B, N) bool over score-sorted boxes (B, N, 4) f32.

    It calls the custom operator ``openset_rcnn::nms_keep``, so eager code
    and an exported program take one route: CPU tensors take the plain
    version; CUDA tensors launch the kernel's two passes (the IoU bitmask,
    then the walk), counted by the tracer as ``kernel.nms_keep`` once a
    call, both passes together (the operator's CUDA implementation counts
    them, so a loaded exported program counts too). Tensors on another
    device are refused (the operator itself also takes meta and fake
    tensors, for tracing).
    """
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms_keep runs on CPU or CUDA tensors, not {boxes.device}")
    return nms_keep_op(boxes, valid, float(thresh))


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    keep_fn: KeepFn = nms_keep,
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
    keep_fn: KeepFn = nms_keep,
) -> NMSResult:
    """Class-aware NMS via the coordinate-offset trick (d2 batched_nms)."""
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.amax(dim=(1, 2)) + 1.0
    offsets = class_ids.to(boxes.dtype)[..., None] * max_coord[:, None, None]
    return nms_mask(boxes + offsets, scores, valid, iou_threshold, keep_fn)
