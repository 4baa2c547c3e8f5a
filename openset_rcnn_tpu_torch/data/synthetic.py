"""Synthetic dataset: colored rectangles on disk, for tests/benchmarks/e2e
smoke runs (SURVEY.md §4 item 5) — no external downloads needed.

Copy of ``openset_rcnn_tpu/data/synthetic.py``, kept in the port so that it
imports nothing of the JAX package; ``cv2`` is imported inside the function.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def generate_synthetic_dataset(
    root: str,
    num_images: int = 10,
    image_hw: Tuple[int, int] = (240, 320),
    num_classes: int = 3,
    max_objects: int = 4,
    seed: int = 0,
    color_seed: int | None = None,
) -> List[dict]:
    """Write PNGs of colored rectangles; return dataset dicts.

    Each class gets a distinct color so the detection task is learnable.
    ``color_seed`` pins the class->color map independently of ``seed`` so a
    train and test split drawn with different seeds depict the same classes
    (numpy fills row-major, so a split with MORE classes and the same
    color_seed keeps the shared prefix of colors identical).
    """
    import cv2

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    colors = (
        np.random.RandomState(color_seed).randint(60, 255, (num_classes, 3)).tolist()
        if color_seed is not None
        else rng.randint(60, 255, (num_classes, 3)).tolist()
    )
    h, w = image_hw
    records = []
    for i in range(num_images):
        img = np.full((h, w, 3), 30, np.uint8)
        n = rng.randint(1, max_objects + 1)
        annos = []
        for _ in range(n):
            bw = rng.randint(w // 8, w // 3)
            bh = rng.randint(h // 8, h // 3)
            x1 = rng.randint(0, w - bw)
            y1 = rng.randint(0, h - bh)
            cls = rng.randint(num_classes)
            cv2.rectangle(img, (x1, y1), (x1 + bw, y1 + bh), colors[cls], -1)
            annos.append(
                {
                    "bbox": [float(x1), float(y1), float(x1 + bw), float(y1 + bh)],
                    "category_id": int(cls),
                    "difficult": 0,
                }
            )
        path = os.path.join(root, f"img_{i:04d}.png")
        cv2.imwrite(path, img)
        records.append(
            {
                "file_name": path,
                "image_id": i,
                "height": h,
                "width": w,
                "annotations": annos,
            }
        )
    return records
