"""Minimal COCO-JSON handling (no pycocotools — it is not in this image).

Copy of ``openset_rcnn_tpu/data/coco.py``, kept in the port so
that it imports nothing of the JAX package.

Covers what the reference consumes from pycocotools' ``COCO``
(data/graspnet.py:23-208): annotation indexing by image, category tables,
and the GraspNet-OS behavioral delta — the TRAINING split keeps only
annotations of the 28 known categories while test splits keep all 88
(data/graspnet.py:190-195).
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


class CocoJson:
    """Tiny indexed view over a COCO-format annotation file or dict."""

    def __init__(self, source):
        if isinstance(source, str):
            with open(source) as f:
                data = json.load(f)
        else:
            data = source
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.anns = {}
        for ann in data.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann

    def category_ids(self) -> List[int]:
        return sorted(self.cats)


def load_coco_instances(
    json_file: str,
    image_root: str,
    dataset_name: Optional[str] = None,
    keep_category_ids: Optional[Sequence[int]] = None,
    id_to_contiguous: Optional[Dict[int, int]] = None,
) -> List[dict]:
    """Dataset dicts from a COCO json.

    Args:
        keep_category_ids: if given, drop annotations of other categories
            (the GraspNet-OS train-time known-class filter).
        id_to_contiguous: dataset category id -> contiguous id map; defaults
            to sorted-order enumeration.
    """
    coco = CocoJson(json_file)
    if id_to_contiguous is None:
        id_to_contiguous = {cid: i for i, cid in enumerate(coco.category_ids())}
    keep = set(keep_category_ids) if keep_category_ids is not None else None

    dicts = []
    for img_id, img in coco.imgs.items():
        annos = []
        for ann in coco.img_to_anns.get(img_id, []):
            if ann.get("iscrowd", 0):
                continue
            cid = ann["category_id"]
            if keep is not None and cid not in keep:
                continue
            x, y, w, h = ann["bbox"]
            annos.append(
                {
                    "bbox": [x, y, x + w, y + h],
                    "category_id": id_to_contiguous[cid],
                    "dataset_category_id": cid,
                    "difficult": 0,
                }
            )
        dicts.append(
            {
                "file_name": os.path.join(image_root, img["file_name"]),
                "image_id": img_id,
                "height": img["height"],
                "width": img["width"],
                "annotations": annos,
            }
        )
    return dicts
