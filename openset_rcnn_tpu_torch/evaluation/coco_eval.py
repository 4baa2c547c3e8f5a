"""Open-set COCO evaluator wrapper (GraspNet-OS benchmark path).

Copy of ``openset_rcnn_tpu/evaluation/coco_eval.py``, kept in the port so
that it imports nothing of the JAX package.

Rebuild of the reference's ``OpensetCOCOEvaluator``
(evaluation/os_coco_evaluation.py:32-621): collects predictions as
COCO-json records, persists them for ``--resume_test`` re-scoring
(:177-184, as JSON instead of torch .pth), relabels GT of non-known
categories to the unknown id before scoring (:603-605), runs the open-set
COCOeval core with the known category ids and maxDets [10,20,30,50,100]
(train.py:69), and derives the metric dict incl. WI/AOSE and per-category
AP (:336-431).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.catalog import MetadataCatalog
from ..data.coco import CocoJson
from .os_cocoeval import OpenSetCocoEval

logger = logging.getLogger(__name__)

KNOWN_METRIC_NAMES = [
    "AP", "AP50", "AP75", "APs", "APm", "APl",
    "AR@10", "AR@20", "AR@30", "AR@50", "AR@100",
    "ARs", "ARm", "ARl", "WI", "AOSE",
]
UNKNOWN_METRIC_NAMES = [
    "AP-unknown", "AP50-unknown", "AP75-unknown", "APs-unknown",
    "APm-unknown", "APl-unknown",
    "AR@10-unknown", "AR@20-unknown", "AR@30-unknown", "AR@50-unknown",
    "AR@100-unknown",
    "ARs-unknown", "ARm-unknown", "ARl-unknown",
]


class OpensetCocoEvaluator:
    def __init__(
        self,
        dataset_name: str,
        known_ids: Optional[Sequence[int]] = None,
        cfg=None,
        output_dir: Optional[str] = None,
        max_dets: Sequence[int] = (10, 20, 30, 50, 100),
        unknown_id: int = 1000,
        eval_type: str = "openset",
    ):
        self.dataset_name = dataset_name
        meta = MetadataCatalog.get(dataset_name)
        self.meta = meta
        self.output_dir = output_dir
        self.max_dets = tuple(max_dets)
        self.unknown_id = unknown_id
        # "openset" is the benchmark protocol; "cls_agn_unk" reports the
        # recall-focused subset (the reference's other --eval_type values,
        # train.py:254-260). "Closeset" is rejected up front: the reference
        # CLI accepts it but its scoring path asserts eval_type == "openset"
        # (os_coco_evaluation.py:602) and crashes — we fail fast with a
        # clear message instead of silently scoring openset.
        if eval_type not in ("openset", "cls_agn_unk"):
            raise ValueError(
                f"eval_type {eval_type!r} is not supported on the COCO path "
                "(the reference's Closeset branch is vestigial and asserts "
                "out at scoring); use 'openset' or 'cls_agn_unk'."
            )
        self.eval_type = eval_type

        if known_ids is None:
            from ..data.graspnet_meta import GRASPNET_KNOWN_IDS

            known_ids = GRASPNET_KNOWN_IDS
        self.known_ids = sorted(known_ids)

        # contiguous -> dataset id (reverse of the loader's map)
        contig = meta.get("thing_dataset_id_to_contiguous_id", {})
        self._reverse_id_map = {v: k for k, v in contig.items()}
        self._predictions: List[dict] = []

    # ------------------------------------------------------------------ api
    def reset(self):
        self._predictions = []

    def process(self, image_id, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray):
        """classes: contiguous ids for known detections, unknown_id for
        unknown. Boxes xyxy in original image coordinates."""
        for (x1, y1, x2, y2), s, c in zip(boxes, scores, classes):
            c = int(c)
            if c != self.unknown_id:
                c = self._reverse_id_map.get(c, c)
            self._predictions.append(
                {
                    "image_id": int(image_id),
                    "category_id": c,
                    "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                    "score": float(s),
                }
            )

    # ------------------------------------------------------------ persistence
    def save_predictions(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.output_dir, "instances_predictions.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self._predictions, f)
        logger.info("saved %d predictions to %s", len(self._predictions), path)
        return path

    def load_predictions(self, path: Optional[str] = None):
        path = path or os.path.join(self.output_dir, "instances_predictions.json")
        with open(path) as f:
            self._predictions = json.load(f)
        logger.info("loaded %d predictions from %s", len(self._predictions), path)

    # ----------------------------------------------------------------- eval
    def evaluate(self, resume: bool = False) -> Dict[str, float]:
        # multi-process eval: merge per-process predictions (reference
        # comm.gather, os_coco_evaluation.py:163-169)
        from ..parallel import gather_object, is_main_process, num_processes

        if not resume and num_processes() > 1:
            merged = []
            for part in gather_object(self._predictions):
                merged.extend(part)
            self._predictions = merged

        if resume:
            self.load_predictions()
        elif self.output_dir and is_main_process():
            self.save_predictions()

        coco = CocoJson(self.meta.json_file)
        gt_anns = []
        known = set(self.known_ids)
        for ann in coco.dataset.get("annotations", []):
            a = dict(ann)
            if a["category_id"] not in known:
                a["category_id"] = self.unknown_id  # open-set relabel
            gt_anns.append(a)
        image_ids = sorted(coco.imgs)

        ev = OpenSetCocoEval(
            gt_anns=gt_anns,
            dt_anns=self._predictions,
            image_ids=image_ids,
            known_cat_ids=self.known_ids,
            unknown_id=self.unknown_id,
            max_dets=self.max_dets,
        )
        acc = ev.run()
        stats = ev.summarize(acc)

        if self.eval_type == "cls_agn_unk":
            # Recall-centric view (reference _derive_coco_results
            # cls_agn_unk branch): AR@{10..100} + AP of the known classes.
            names = ["AR@10", "AR@20", "AR@30", "AR@50", "AR@100", "AP"]
            vals = list(stats[6:11]) + [stats[0]]
            return {
                n: round(float(v) * 100, 4) if v != -1 else float("nan")
                for n, v in zip(names, vals)
            }

        results: Dict[str, float] = {}
        for name, value in zip(KNOWN_METRIC_NAMES, stats[:16]):
            scale = 1.0 if name in ("WI", "AOSE") else 100.0
            results[name] = round(float(value) * scale, 4) if value != -1 else float("nan")
        for name, value in zip(UNKNOWN_METRIC_NAMES, stats[16:]):
            results[name] = round(float(value) * 100, 4) if value != -1 else float("nan")

        # PR-curve dumps for offline analysis (os_coco_evaluation.py:428-431)
        if self.output_dir and is_main_process():
            os.makedirs(self.output_dir, exist_ok=True)
            np.save(os.path.join(self.output_dir, "known_precision_bbox.npy"), acc["precision"])
            np.save(os.path.join(self.output_dir, "known_recall_bbox.npy"), acc["recall"])
            np.save(os.path.join(self.output_dir, "unknown_precision_bbox.npy"), acc["u_precision"])
            np.save(os.path.join(self.output_dir, "unknown_recall_bbox.npy"), acc["u_recall"])

        # per-category AP50:95 (os_coco_evaluation.py:393-411)
        classes = self.meta.get("thing_classes")
        contig = self.meta.get("thing_dataset_id_to_contiguous_id", {})
        if classes:
            for ki, cat_id in enumerate(sorted(self.known_ids)):
                prec = acc["precision"][:, :, ki, 0, -1]
                valid = prec[prec > -1]
                ap = float(valid.mean() * 100) if valid.size else float("nan")
                name = classes[contig[cat_id]] if cat_id in contig else str(cat_id)
                results[f"AP-{name}"] = round(ap, 4)
        logger.info(
            "open-set COCO results (%s): %s",
            self.dataset_name,
            {k: results[k] for k in ("AP", "AP50", "WI", "AOSE", "AP-unknown") if k in results},
        )
        return results
