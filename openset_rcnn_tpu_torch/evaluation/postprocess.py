"""Open-set cascade settings.

Copy of ``PostprocessConfig`` and its ``from_cfg`` from
``openset_rcnn_tpu/evaluation/postprocess.py:92-125``. The host cascade
itself is a later slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


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
            # OpenDet benchmark: unknown = the last contiguous class id (80 for
            # the 81-class VOC-COCO set). GraspNet uses UNKNOWN_ID (1000).
            unknown_id=rh.NUM_CLASSES - 1 if opendet_benchmark else rh.UNKNOWN_ID,
            class_id_table=class_id_table,
        )
