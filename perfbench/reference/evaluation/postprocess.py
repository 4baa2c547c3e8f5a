"""The host side of the fused cascade, for the reference: the cascade's
settings and the rescale of the detections to the original image.

Frozen copy of ``PostprocessConfig`` and ``finalize_serve_image`` from
``openset_rcnn_tpu_torch/evaluation/postprocess.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class FinalDetections:
    boxes: np.ndarray    # (N, 4) xyxy in ORIGINAL image coordinates
    scores: np.ndarray   # (N,)
    classes: np.ndarray  # (N,) contiguous ids; unknown id per benchmark


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
