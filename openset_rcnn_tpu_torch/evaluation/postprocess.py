"""Host-side inference cascade (numpy).

Finishes what the device's ``RawDetections`` started, reproducing the
reference's 3-stage filter chain exactly (SURVEY.md §3.2):

  stage 1 — objectness filter + top-k (osrcnn_fast_rcnn.py:89-145): keep
            finite boxes with sqrt(iou*ctr) > OBJ_SCORE_THRESH (0.05), NMS at
            1.0 (a no-op kept for parity), top DETECTIONS_PER_IMAGE by score;
  stage 2 — open-set split (prototype_learning_network.py:189-230): unknown
            iff min prototype distance > UNK_THR;
  stage 3 — known: per-class softmax scores > thresh, class-wise NMS, top-k;
            unknown: objectness score, single-class NMS, top-k, fixed class
            id (softmax_classifier.py:287-345).

Runs on small arrays per image; exact dynamic filtering is natural here and
keeps the device graph static.

Copy of ``openset_rcnn_tpu/evaluation/postprocess.py``, kept in the port so
that it imports nothing of the JAX package. ``numpy_nms`` dispatches to the
port's build of ``native/evalcore.cpp`` (``evalcore_binding``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

_NMS_NATIVE_WARNED = False


@dataclass
class FinalDetections:
    boxes: np.ndarray    # (N, 4) xyxy in ORIGINAL image coordinates
    scores: np.ndarray   # (N,)
    classes: np.ndarray  # (N,) contiguous ids; unknown id per benchmark


def numpy_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy NMS, strict '>' suppression (torchvision semantics).

    Returns kept indices in descending-score order. Dispatches to the C++
    evalcore when built (native/evalcore.cpp).
    """
    order = np.argsort(-scores, kind="stable")
    if len(order) > 8:
        try:
            from .evalcore_binding import nms_native

            keep_mask = nms_native(boxes[order], thresh)
            return order[keep_mask]
        except (ImportError, OSError, RuntimeError):
            # expected: extension not built / toolchain absent -> numpy fallback
            pass
        except Exception:
            # unexpected (layout/binding bug): still fall back, but say so once
            # instead of silently degrading every host-cascade NMS to the
            # O(N^2) numpy loop (mirrors os_cocoeval.greedy_match dispatch)
            global _NMS_NATIVE_WARNED
            if not _NMS_NATIVE_WARNED:
                _NMS_NATIVE_WARNED = True
                import logging, traceback

                logging.getLogger(__name__).warning(
                    "native nms failed unexpectedly; using numpy fallback:\n%s",
                    traceback.format_exc(),
                )
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1) * (y2 - y1)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(x1[i], x1)
        yy1 = np.maximum(y1[i], y1)
        xx2 = np.minimum(x2[i], x2)
        yy2 = np.minimum(y2[i], y2)
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        union = areas[i] + areas - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        suppressed |= iou > thresh
        suppressed[i] = True  # already kept; never revisited
    return np.asarray(keep, np.int64)


def batched_numpy_nms(boxes, scores, classes, thresh) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    offset = (boxes.max() + 1.0) * classes.astype(boxes.dtype)
    return numpy_nms(boxes + offset[:, None], scores, thresh)


@dataclass
class PostprocessConfig:
    obj_score_thresh: float = 0.05
    stage1_nms_thresh: float = 1.0
    detections_per_image: int = 1000
    unk_thr: float = 0.23
    known_score_thresh: float = 0.05
    known_nms_thresh: float = 0.5
    known_topk: int = 50
    unknown_score_thresh: float = 0.0
    unknown_nms_thresh: float = 0.5
    unknown_topk: int = 50
    unknown_id: int = 80            # 80 for OpenDet benchmark, 1000 for GraspNet
    class_id_table: Optional[np.ndarray] = None  # known idx -> contiguous id (GraspNet)

    @staticmethod
    def from_cfg(cfg, opendet_benchmark: bool, class_id_table=None) -> "PostprocessConfig":
        rh = cfg.MODEL.ROI_HEADS
        return PostprocessConfig(
            obj_score_thresh=rh.OBJ_SCORE_THRESH_TEST,
            stage1_nms_thresh=rh.NMS_THRESH_TEST,
            detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
            unk_thr=cfg.MODEL.PLN.UNK_THR,
            known_score_thresh=rh.KNOWN_SCORE_THRESH,
            known_nms_thresh=rh.KNOWN_NMS_THRESH,
            known_topk=rh.KNOWN_TOPK,
            unknown_score_thresh=rh.UNKNOWN_SCORE_THRESH,
            unknown_nms_thresh=rh.UNKNOWN_NMS_THRESH,
            unknown_topk=rh.UNKNOWN_TOPK,
            # OpenDet benchmark: unknown = the last contiguous class id
            # (80 for the 81-class VOC-COCO set; the reference hardcodes 80
            # because it only ever runs 81 classes,
            # prototype_learning_network.py:219-223). GraspNet uses 1000.
            unknown_id=rh.NUM_CLASSES - 1 if opendet_benchmark else rh.UNKNOWN_ID,
            class_id_table=class_id_table,
        )


def finalize_serve_image(
    boxes: np.ndarray,    # (D, 4) network-input coordinates
    scores: np.ndarray,   # (D,)
    classes: np.ndarray,  # (D,) known class idx or cfg.unknown_id
    valid: np.ndarray,    # (D,)
    input_hw,
    output_hw,
    cfg: PostprocessConfig,
) -> FinalDetections:
    """Host finalize for the fused on-device cascade (models/serving.py):
    the filtering/NMS already ran on-device; what remains is the d2
    ``detector_postprocess`` rescale to original coordinates plus the
    GraspNet known-idx -> contiguous-id remap, exactly as in
    :func:`postprocess_image`'s tail."""
    b = boxes[valid]
    s = scores[valid]
    c = classes[valid].astype(np.int64)
    if cfg.class_id_table is not None and len(c):
        known = c != cfg.unknown_id
        c = np.where(known, cfg.class_id_table[np.where(known, c, 0)], c)
    sy = output_hw[0] / input_hw[0]
    sx = output_hw[1] / input_hw[1]
    out = b * np.asarray([sx, sy, sx, sy], b.dtype)
    out[:, 0::2] = np.clip(out[:, 0::2], 0, output_hw[1])
    out[:, 1::2] = np.clip(out[:, 1::2], 0, output_hw[0])
    return FinalDetections(boxes=out, scores=s, classes=c)


def postprocess_image(
    boxes: np.ndarray,        # (P, 4) clipped to network-input extent
    objectness: np.ndarray,   # (P,)
    min_dist: np.ndarray,     # (P,)
    pln_class: np.ndarray,    # (P,) known class index argmin
    known_probs: np.ndarray,  # (P, K+1)
    valid: np.ndarray,        # (P,)
    input_hw,                 # (h, w) network-input image size
    output_hw,                # (h, w) original image size
    cfg: PostprocessConfig,
) -> FinalDetections:
    # ---- stage 1: objectness filter + topk ----
    finite = np.isfinite(boxes).all(1) & np.isfinite(objectness)
    keep = valid & finite & (objectness > cfg.obj_score_thresh)
    idx = np.where(keep)[0]
    if cfg.stage1_nms_thresh < 1.0 and len(idx):
        k = numpy_nms(boxes[idx], objectness[idx], cfg.stage1_nms_thresh)
        idx = idx[k]
    else:
        idx = idx[np.argsort(-objectness[idx], kind="stable")]
    idx = idx[: cfg.detections_per_image]

    b = boxes[idx]
    obj = objectness[idx]
    md = min_dist[idx]
    pc = pln_class[idx]
    probs = known_probs[idx]

    # ---- stage 2: open-set split ----
    is_unknown = md > cfg.unk_thr

    # ---- stage 3a: known branch (class-wise) ----
    kb = b[~is_unknown]
    kprobs = probs[~is_unknown][:, :-1]  # drop background column
    if kb.shape[0]:
        det_idx, det_cls = np.nonzero(kprobs > cfg.known_score_thresh)
        kboxes = kb[det_idx]
        kscores = kprobs[det_idx, det_cls]
        order = batched_numpy_nms(kboxes, kscores, det_cls, cfg.known_nms_thresh)
        order = order[: cfg.known_topk]
        kboxes, kscores, kcls = kboxes[order], kscores[order], det_cls[order]
    else:
        kboxes = np.zeros((0, 4), np.float32)
        kscores = np.zeros((0,), np.float32)
        kcls = np.zeros((0,), np.int64)
    if cfg.class_id_table is not None and len(kcls):
        kcls = cfg.class_id_table[kcls]

    # ---- stage 3b: unknown branch (class-agnostic, objectness score) ----
    ub = b[is_unknown]
    uscores = obj[is_unknown]
    m = uscores > cfg.unknown_score_thresh
    ub, uscores = ub[m], uscores[m]
    if len(ub):
        order = numpy_nms(ub, uscores, cfg.unknown_nms_thresh)[: cfg.unknown_topk]
        ub, uscores = ub[order], uscores[order]
    ucls = np.full((len(ub),), cfg.unknown_id, np.int64)

    out_boxes = np.concatenate([ub, kboxes], 0)
    out_scores = np.concatenate([uscores, kscores], 0)
    out_classes = np.concatenate([ucls, kcls], 0)

    # ---- rescale to the original image (d2 detector_postprocess) ----
    sy = output_hw[0] / input_hw[0]
    sx = output_hw[1] / input_hw[1]
    out_boxes = out_boxes * np.asarray([sx, sy, sx, sy], out_boxes.dtype)
    out_boxes[:, 0::2] = np.clip(out_boxes[:, 0::2], 0, output_hw[1])
    out_boxes[:, 1::2] = np.clip(out_boxes[:, 1::2], 0, output_hw[0])
    return FinalDetections(boxes=out_boxes, scores=out_scores, classes=out_classes)
