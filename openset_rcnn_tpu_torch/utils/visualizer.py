"""Detection and dataset visualization (host side, cv2).

Copy of ``openset_rcnn_tpu/utils/visualizer.py:1-83``, kept in the port so
that it imports nothing of the JAX package; ``cv2`` is imported inside the
functions that draw or write, so importing the port needs no ``cv2``:

    python -m openset_rcnn_tpu_torch.utils.visualizer --dataset graspnet_test_1 \\
        --num 5 --out viz/

Draws GT boxes with class names; prediction overlays draw knowns in
per-class colors and unknowns in red.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

_UNKNOWN_COLOR = (0, 0, 255)  # BGR red


def _color_for(idx: int):
    rng = np.random.RandomState(idx * 7919 + 13)
    return tuple(int(c) for c in rng.randint(64, 255, 3))


def draw_boxes(
    image: np.ndarray,
    boxes: np.ndarray,
    labels: Optional[Sequence[str]] = None,
    classes: Optional[np.ndarray] = None,
    scores: Optional[np.ndarray] = None,
    unknown_id: Optional[int] = None,
    thickness: int = 2,
) -> np.ndarray:
    """Returns a copy of image (BGR uint8) with boxes drawn."""
    import cv2

    out = image.copy()
    for i, box in enumerate(np.asarray(boxes).reshape(-1, 4)):
        x1, y1, x2, y2 = (int(round(float(v))) for v in box)
        cid = int(classes[i]) if classes is not None else 0
        color = _UNKNOWN_COLOR if (unknown_id is not None and cid == unknown_id) else _color_for(cid)
        cv2.rectangle(out, (x1, y1), (x2, y2), color, thickness)
        text = ""
        if labels is not None and i < len(labels):
            text = str(labels[i])
        if scores is not None:
            text = f"{text} {float(scores[i]):.2f}".strip()
        if text:
            cv2.putText(out, text, (x1, max(y1 - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return out


def visualize_dataset(dataset_name: str, out_dir: str, num: int = 5):
    import cv2

    from ..data import DatasetCatalog, MetadataCatalog, register_builtin_datasets

    register_builtin_datasets()
    records = DatasetCatalog.get(dataset_name)[:num]
    meta = MetadataCatalog.get(dataset_name)
    classes = meta.get("thing_classes", [])
    os.makedirs(out_dir, exist_ok=True)
    for rec in records:
        img = cv2.imread(rec["file_name"])
        if img is None:
            img = np.zeros((rec["height"], rec["width"], 3), np.uint8)
        annos = rec.get("annotations", [])
        boxes = np.asarray([a["bbox"] for a in annos]).reshape(-1, 4)
        ids = np.asarray([a["category_id"] for a in annos], int)
        labels = [classes[c] if c < len(classes) else str(c) for c in ids]
        out = draw_boxes(img, boxes, labels=labels, classes=ids)
        path = os.path.join(out_dir, f"{rec['image_id']}.jpg")
        cv2.imwrite(path, out)
        print("wrote", path)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", default="viz")
    p.add_argument("--num", type=int, default=5)
    a = p.parse_args()
    visualize_dataset(a.dataset, a.out, a.num)
