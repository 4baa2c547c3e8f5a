"""Open-set PASCAL-VOC evaluation (OpenDet protocol).

Copy of ``openset_rcnn_tpu/evaluation/voc_eval.py``, kept in the port so
that it imports nothing of the JAX package.

Host-side numpy rebuild of the reference's OWOD-derived evaluator
(evaluation/pascal_voc_evaluation.py:21-379). Semantics reproduced exactly:

  * GT classes outside the known set are relabeled "unknown" (:227-228);
  * per-class VOC AP at IoU 0.5 with the +1-pixel extent convention
    (:246-264) and the detections' (+1, +1) xmin/ymin offset (:64-67);
  * difficult GT is excluded from npos and absorbs matches silently;
  * per known class, detections overlapping ANY unknown GT above the
    threshold count into fp_open_set (:358-377);
  * WI = mean(fp_os) / mean(tp+fp_cs) at the detection index whose recall is
    closest to 0.8, averaged over known classes with detections, x100
    (:82-99, :174-176);
  * AOSE = total detections-overlapping-unknown over known classes (:178-182);
  * AP@K / P@K / R@K = means over the known classes; AP@U / P@U / R@U from
    the "unknown" class (:191-202).

The evaluator is in-memory (predictions collected as arrays, not temp
files); per-class detection files are still written for debuggability.
"""
from __future__ import annotations

import logging
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def voc_overlaps(gt_boxes: np.ndarray, box: np.ndarray) -> np.ndarray:
    """IoU of one box against (N, 4) GTs with the VOC +1 extent convention."""
    ixmin = np.maximum(gt_boxes[:, 0], box[0])
    iymin = np.maximum(gt_boxes[:, 1], box[1])
    ixmax = np.minimum(gt_boxes[:, 2], box[2])
    iymax = np.minimum(gt_boxes[:, 3], box[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inter = iw * ih
    union = (
        (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
        + (gt_boxes[:, 2] - gt_boxes[:, 0] + 1.0) * (gt_boxes[:, 3] - gt_boxes[:, 1] + 1.0)
        - inter
    )
    return inter / union


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """All-points interpolated VOC AP (use_07_metric=False)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class OpensetVocEvaluator:
    """Collect per-image detections, then compute open-set VOC metrics.

    GT is supplied as dataset dicts (see data/voc.py) so the evaluator is
    decoupled from the XML filesystem layout; an adapter builds the same
    structures the reference parses from Annotations/*.xml.
    """

    def __init__(
        self,
        class_names: Sequence[str],
        num_known_classes: int,
        output_dir: Optional[str] = None,
        iou_thresh: float = 0.5,
    ):
        self.class_names = list(class_names)  # 20 known + 60 coco + 'unknown'
        self.num_known_classes = num_known_classes
        self.known_classes = set(self.class_names[:num_known_classes])
        self.output_dir = output_dir
        self.iou_thresh = iou_thresh
        self.reset()
        # gt: image_id -> dict(name -> {boxes, difficult})
        self._gt: Dict[str, Dict[str, dict]] = {}

    # ------------------------------------------------------------------ GT
    def add_ground_truth(self, image_id: str, boxes, class_names, difficult):
        """Register GT for one image; unseen class names become 'unknown'."""
        per_class: Dict[str, dict] = {}
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        difficult = np.asarray(difficult, bool).reshape(-1)
        names = [n if n in self.known_classes else "unknown" for n in class_names]
        for cls in set(names):
            sel = [i for i, n in enumerate(names) if n == cls]
            per_class[cls] = {
                "boxes": boxes[sel],
                "difficult": difficult[sel],
            }
        self._gt[image_id] = per_class

    # ---------------------------------------------------------- detections
    def reset(self):
        self._dets = defaultdict(list)  # class id -> [(image_id, score, x1,y1,x2,y2)]

    def process(self, image_id: str, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray):
        """Record detections for one image. Boxes in original coordinates;
        the VOC (+1, +1) xmin/ymin convention is applied here, mirroring the
        reference's process() (:64-67)."""
        for (x1, y1, x2, y2), s, c in zip(boxes, scores, classes):
            self._dets[int(c)].append((image_id, float(s), x1 + 1.0, y1 + 1.0, x2, y2))

    # ---------------------------------------------------------------- eval
    def _eval_class(self, cls_name: str, dets: List[tuple]):
        """Standard VOC matching for one class + open-set counters."""
        # collect GT of this class
        class_gt = {}
        npos = 0
        for image_id, per_class in self._gt.items():
            entry = per_class.get(cls_name)
            if entry is None:
                class_gt[image_id] = {
                    "boxes": np.zeros((0, 4)),
                    "difficult": np.zeros((0,), bool),
                    "matched": np.zeros((0,), bool),
                }
            else:
                class_gt[image_id] = {
                    "boxes": entry["boxes"],
                    "difficult": entry["difficult"],
                    "matched": np.zeros(len(entry["boxes"]), bool),
                }
                npos += int((~entry["difficult"]).sum())

        if not dets:
            empty = np.zeros((0,))
            return dict(rec=empty, prec=empty, ap=0.0, is_unk=empty, npos=npos,
                        tp_plus_fp=empty, image_ids=[], n=0)

        scores = np.asarray([d[1] for d in dets])
        order = np.argsort(-scores)
        image_ids = [dets[i][0] for i in order]
        bbs = np.asarray([[dets[i][2], dets[i][3], dets[i][4], dets[i][5]] for i in order])

        nd = len(order)
        tp = np.zeros(nd)
        fp = np.zeros(nd)
        is_unk = np.zeros(nd)
        for d in range(nd):
            rec_entry = class_gt.get(image_ids[d])
            bb = bbs[d]
            matched = False
            if rec_entry is not None and len(rec_entry["boxes"]):
                ov = voc_overlaps(rec_entry["boxes"], bb)
                jmax = int(np.argmax(ov))
                if ov[jmax] > self.iou_thresh:
                    matched = True
                    if not rec_entry["difficult"][jmax]:
                        if not rec_entry["matched"][jmax]:
                            tp[d] = 1.0
                            rec_entry["matched"][jmax] = True
                        else:
                            fp[d] = 1.0
            if not matched:
                fp[d] = 1.0
            # open-set: does this detection cover an unknown GT?
            if cls_name != "unknown":
                unk = self._gt.get(image_ids[d], {}).get("unknown")
                if unk is not None and len(unk["boxes"]):
                    if np.max(voc_overlaps(unk["boxes"], bb)) > self.iou_thresh:
                        is_unk[d] = 1.0

        tp_c = np.cumsum(tp)
        fp_c = np.cumsum(fp)
        rec = tp_c / float(max(npos, 1))
        prec = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
        return dict(
            rec=rec, prec=prec, ap=voc_ap(rec, prec), is_unk=np.cumsum(is_unk),
            npos=npos, tp_plus_fp=tp_c + fp_c, image_ids=image_ids, n=nd,
        )

    def _load_detections(self):
        """Reload the per-class detection files written by a previous
        evaluate() — the VOC-path equivalent of the reference's
        ``instances_predictions.pth`` re-scoring (--resume_test,
        os_coco_evaluation.py:177-184; the reference's VOC evaluator has no
        such path and train.py:283-284 asserts it away — we support it)."""
        if not self.output_dir:
            raise ValueError("--resume_test needs OUTPUT_DIR with saved detections")
        det_dir = os.path.join(self.output_dir, "pascal_voc_eval")
        if not os.path.isdir(det_dir):
            raise FileNotFoundError(
                f"no saved detections at {det_dir}; run eval once before --resume_test"
            )
        # GT keys may be non-str (synthetic datasets use ints)
        key_of = {str(k): k for k in self._gt}
        self.reset()
        for cid, name in enumerate(self.class_names):
            path = os.path.join(det_dir, f"{name}.txt")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                for line in f:
                    img, s, x1, y1, x2, y2 = line.split()
                    # stored values already carry the VOC (+1, +1) offset
                    self._dets[cid].append(
                        (key_of.get(img, img), float(s),
                         float(x1), float(y1), float(x2), float(y2))
                    )

    def evaluate(self, resume: bool = False) -> Dict[str, float]:
        # multi-process eval: merge per-process detections (reference
        # comm.gather, pascal_voc_evaluation.py:106)
        from ..parallel import gather_object, is_main_process, num_processes

        if resume:
            self._load_detections()

        if num_processes() > 1:
            merged = defaultdict(list)
            for part in gather_object(dict(self._dets)):
                for cid, dets in part.items():
                    merged[cid].extend(dets)
            self._dets = merged

        if self.output_dir and is_main_process():  # the merged detections: one writer
            det_dir = os.path.join(self.output_dir, "pascal_voc_eval")
            os.makedirs(det_dir, exist_ok=True)
            for cid, dets in self._dets.items():
                name = self.class_names[cid] if cid < len(self.class_names) else str(cid)
                with open(os.path.join(det_dir, f"{name}.txt"), "w") as f:
                    for (img, s, x1, y1, x2, y2) in dets:
                        f.write(f"{img} {s:.3f} {x1:.1f} {y1:.1f} {x2:.1f} {y2:.1f}\n")

        per_class = {}
        for cid, cls_name in enumerate(self.class_names):
            per_class[cls_name] = self._eval_class(cls_name, self._dets.get(cid, []))

        K = self.num_known_classes
        known = [per_class[self.class_names[i]] for i in range(K)]
        unknown = per_class.get("unknown", None)

        # WI at recall level 0.8
        fps, tpfps = [], []
        for r in known:
            if r["n"] == 0:
                continue
            i = int(np.argmin(np.abs(r["rec"] - 0.8)))
            fps.append(r["is_unk"][i])
            tpfps.append(r["tp_plus_fp"][i])
        wi = (np.mean(fps) / np.mean(tpfps)) if tpfps and np.mean(tpfps) > 0 else 0.0

        aose = float(np.sum([r["is_unk"][-1] if r["n"] else 0.0 for r in known]))

        def last(r, key):
            return float(r[key][-1] * 100) if r["n"] else 0.0

        results = {
            "mAP": float(np.mean([per_class[c]["ap"] for c in self.class_names]) * 100),
            "WI": float(wi * 100),
            "AOSE": aose,
            "AP@K": float(np.mean([r["ap"] for r in known]) * 100),
            "P@K": float(np.mean([last(r, "prec") for r in known])),
            "R@K": float(np.mean([last(r, "rec") for r in known])),
            "AP@U": float(unknown["ap"] * 100) if unknown else 0.0,
            "P@U": last(unknown, "prec") if unknown else 0.0,
            "R@U": last(unknown, "rec") if unknown else 0.0,
        }
        logger.info("Open-set VOC results: %s", {k: round(v, 2) for k, v in results.items()})
        return {k: round(v, 2) for k, v in results.items()}
