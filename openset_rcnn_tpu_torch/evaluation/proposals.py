"""Class-agnostic proposal recall (AR) evaluation.

Copy of ``openset_rcnn_tpu/evaluation/proposals.py``, kept in the port so
that it imports nothing of the JAX package.

Rebuild of the reference's box-proposal evaluator
(evaluation/os_coco_evaluation.py:297-334, 465-573): average recall of RPN
proposals against ALL GT boxes (known + unknown pooled), over IoU
thresholds 0.5:0.05:0.95, detection limits (e.g. 100/1000) and COCO area
ranges. Matching is the greedy highest-IoU-first assignment the COCO
proposal evaluator uses.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .os_cocoeval import AREA_RNGS

IOU_THRS = np.linspace(0.5, 0.95, 10)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def evaluate_box_proposals(
    proposals_per_image: List[dict],
    gt_per_image: Dict,
    limits: Sequence[int] = (100, 1000),
    areas: Sequence[str] = ("all", "small", "medium", "large"),
) -> Dict[str, float]:
    """Args:
        proposals_per_image: [{image_id, boxes (N,4) xyxy, scores (N,)}].
        gt_per_image: image_id -> (M, 4) xyxy GT boxes.
    Returns:
        {"AR@100": ..., "AR@1000": ..., "AR@100-small": ..., ...}
    """
    results: Dict[str, float] = {}
    for area in areas:
        a_lo, a_hi = AREA_RNGS[area]
        for limit in limits:
            gt_overlaps = []
            num_pos = 0
            for entry in proposals_per_image:
                boxes = np.asarray(entry["boxes"], np.float64).reshape(-1, 4)
                scores = np.asarray(entry["scores"], np.float64).reshape(-1)
                order = np.argsort(-scores, kind="stable")[:limit]
                boxes = boxes[order]
                gt = np.asarray(
                    gt_per_image.get(entry["image_id"], np.zeros((0, 4))), np.float64
                ).reshape(-1, 4)
                if len(gt):
                    ga = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
                    gt = gt[(ga >= a_lo) & (ga <= a_hi)]
                num_pos += len(gt)
                if len(gt) == 0 or len(boxes) == 0:
                    continue
                overlaps = _iou_matrix(boxes, gt)
                # greedy: repeatedly take the globally best (proposal, gt) pair
                matched = np.zeros(len(gt))
                for _ in range(min(len(boxes), len(gt))):
                    argmax_overlaps = overlaps.argmax(axis=0)
                    max_overlaps = overlaps.max(axis=0)
                    gt_ind = max_overlaps.argmax()
                    gt_ovr = max_overlaps.max()
                    if gt_ovr < 0:
                        break
                    box_ind = argmax_overlaps[gt_ind]
                    matched[gt_ind] = gt_ovr
                    overlaps[box_ind, :] = -1
                    overlaps[:, gt_ind] = -1
                gt_overlaps.append(matched)

            gt_overlaps = (
                np.concatenate(gt_overlaps) if gt_overlaps else np.zeros(0)
            )
            if num_pos == 0:
                ar = float("nan")
            else:
                recalls = [(gt_overlaps >= t).sum() / num_pos for t in IOU_THRS]
                ar = float(np.mean(recalls))
            suffix = "" if area == "all" else f"-{area}"
            results[f"AR@{limit}{suffix}"] = round(ar * 100, 4)
    return results
