"""Host-side image transforms -> fixed padded buckets.

Rebuilds the reference's d2 ``DatasetMapper`` pipeline (SURVEY.md §2.4):
ResizeShortestEdge (train short side sampled from MIN_SIZE_TRAIN, test 800;
long side capped at 1333) + RandomFlip + BGR pixel order. The TPU-specific
part: every image is padded into one of TWO static buckets (landscape /
portrait, e.g. 832x1344 and 1344x832) so the device sees at most two shapes
(SURVEY.md §7.1). GT boxes are scaled/flipped alongside and padded to
MAX_GT with a validity mask.

Copy of ``openset_rcnn_tpu/data/transforms.py``, kept in the port so that it
imports nothing of the JAX package. Two changes: ``cv2`` and ``PIL`` are
imported inside the functions that use them, so importing the port needs
neither, and the image is read by one overridable method,
``DetectionTransform.read_image``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import tracing


@dataclass
class TransformedExample:
    image: np.ndarray        # (Hb, Wb, 3) uint8 BGR, padded
    image_hw: Tuple[int, int]  # actual size inside the pad
    original_hw: Tuple[int, int]
    bucket_hw: Tuple[int, int]
    boxes: np.ndarray        # (MAX_GT, 4) in network-input coords
    classes: np.ndarray      # (MAX_GT,)
    gt_valid: np.ndarray     # (MAX_GT,)
    image_id: object = None


def resize_shortest_edge(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    """d2 ResizeShortestEdge output size.

    Mirrors detectron2 ``ResizeShortestEdge.get_output_shape`` operation-for-
    operation (short side set to ``short`` FIRST, then the max-size cap is
    applied to the already-scaled pair) so float rounding of the +0.5 cast
    cannot drift from the reference on edge cases.
    """
    size = float(short)
    scale = size / min(h, w)
    if h < w:
        newh, neww = size, scale * w
    else:
        newh, neww = scale * h, size
    if max(newh, neww) > max_size:
        scale = max_size * 1.0 / max(newh, neww)
        newh = newh * scale
        neww = neww * scale
    return int(newh + 0.5), int(neww + 0.5)


def resize_image(img: np.ndarray, nh: int, nw: int, interp: str) -> np.ndarray:
    """Resize a (H, W, 3) uint8 image to (nh, nw).

    interp="pil" reproduces the reference preprocessing exactly: d2's
    ``ResizeTransform.apply_image`` routes uint8 images through
    ``PIL.Image.resize(..., Image.BILINEAR)``, whose downsampling filter
    widens its support by the scale factor (antialiasing). cv2's
    INTER_LINEAR keeps a fixed 2x2 tap, so the two produce different pixels
    whenever scale < 1 — the reference-parity drift suspect VERDICT r3
    named. interp="cv2" keeps the (slightly faster) OpenCV path for
    throughput-only runs.
    """
    if (nh, nw) == img.shape[:2]:
        return img
    if interp == "pil":
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    if interp == "cv2":
        import cv2

        return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    raise ValueError(f"unknown resize interp {interp!r} (expected 'pil' or 'cv2')")


class DetectionTransform:
    def __init__(
        self,
        min_sizes: Sequence[int],
        max_size: int,
        bucket_hw: Tuple[int, int],
        max_gt: int,
        flip: bool,
        fmt: str = "BGR",
        interp: str = "pil",
    ):
        self.min_sizes = tuple(min_sizes)
        self.max_size = max_size
        self.bucket_hw = tuple(bucket_hw)
        self.interp = interp
        # GeneralizedRCNN pads to backbone size-divisibility (SURVEY.md §2.4)
        assert bucket_hw[0] % 32 == 0 and bucket_hw[1] % 32 == 0, (
            f"bucket {bucket_hw} must be divisible by 32"
        )
        self.max_gt = max_gt
        self.flip = flip
        self.fmt = fmt

    def bucket_for(self, h: int, w: int) -> Tuple[int, int]:
        bh, bw = self.bucket_hw
        return (bh, bw) if w >= h else (bw, bh)

    def read_image(self, record: dict) -> Optional[np.ndarray]:
        """The record's (H, W, 3) uint8 BGR pixels, or None if unreadable."""
        import cv2

        return cv2.imread(record["file_name"], cv2.IMREAD_COLOR)

    def __call__(self, record: dict, rng: np.random.RandomState) -> Optional[TransformedExample]:
        tracing.request(record.get("image_id"))
        with tracing.span("data.read"):
            img = self.read_image(record)
        if img is None:
            return None
        with tracing.span("data.transform"):
            ex = self._transform(record, img, rng)
        tracing.count("data.images")
        return ex

    def _transform(self, record: dict, img: np.ndarray, rng: np.random.RandomState) -> TransformedExample:
        if self.fmt == "RGB":
            img = img[:, :, ::-1]
        oh, ow = img.shape[:2]

        short = self.min_sizes[rng.randint(len(self.min_sizes))] if len(self.min_sizes) > 1 else self.min_sizes[0]
        nh, nw = resize_shortest_edge(oh, ow, short, self.max_size)
        img = resize_image(img, nh, nw, self.interp)

        boxes = np.asarray(
            [a["bbox"] for a in record.get("annotations", [])], np.float32
        ).reshape(-1, 4)
        classes = np.asarray(
            [a["category_id"] for a in record.get("annotations", [])], np.int64
        )
        sx, sy = nw / ow, nh / oh
        boxes = boxes * np.asarray([sx, sy, sx, sy], np.float32)

        if self.flip and rng.rand() < 0.5:
            img = img[:, ::-1]
            x1 = nw - boxes[:, 2]
            x2 = nw - boxes[:, 0]
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], axis=1)

        bh, bw = self.bucket_for(nh, nw)
        # keep uint8 end-to-end (decode and cv2 resize are uint8): bit-
        # identical to the old f32 widening but 4x less host memory and
        # host->device transfer; the model casts on device (preprocess).
        padded = np.zeros((bh, bw, 3), np.uint8)
        padded[:nh, :nw] = img

        n = min(len(boxes), self.max_gt)
        out_boxes = np.zeros((self.max_gt, 4), np.float32)
        out_classes = np.zeros((self.max_gt,), np.int32)
        out_valid = np.zeros((self.max_gt,), bool)
        # drop degenerate boxes (empty after clip)
        if n:
            keep = (boxes[:n, 2] > boxes[:n, 0]) & (boxes[:n, 3] > boxes[:n, 1])
            k = int(keep.sum())
            out_boxes[:k] = boxes[:n][keep]
            out_classes[:k] = classes[:n][keep]
            out_valid[:k] = True

        return TransformedExample(
            image=padded,
            image_hw=(nh, nw),
            original_hw=(oh, ow),
            bucket_hw=(bh, bw),
            boxes=out_boxes,
            classes=out_classes,
            gt_valid=out_valid,
            image_id=record.get("image_id"),
        )
