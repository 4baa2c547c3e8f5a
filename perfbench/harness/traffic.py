"""The one traffic generator: a mix's parameters in, seeded inputs out.

A mix (``traffic/<mix>.json``) names its ``kind`` and its parameters:

* ``image_files``: a pool of ``pool`` synthetic JPEG files written under the
  run's temporary directory, with ground truth, in the sizes of ``sizes``
  (``[h, w, share]``, the shares of the pool, counted exactly), a number of
  GT boxes per image from ``gt_per_image`` (``geometric`` with ``mean``,
  ``min`` and ``max``), box sides from ``box_side`` (``log_uniform`` from
  ``min`` pixels to the image's side), classes from ``classes`` (``known``
  ids ``0..known-1``, ``unknown`` ids after them; ``unknown_share`` of the
  boxes unknown) and ``difficult_share`` of the boxes marked difficult;
* ``frames``: a pool of ``pool`` decoded frames in host memory (uint8 BGR),
  in the sizes of ``sizes``, with objects and their ground truth drawn as
  for ``image_files`` where the mix gives ``gt_per_image`` (the frame loop
  serves the pixels only; set-up places the prototypes on the boxes).

Every seed gets the same multiset of image sizes and GT counts (the
distribution's quantiles), in another order, with other pixels, boxes and
classes: the seed moves the content and the order, not the amount of work.
The program receives only the records and pixels made here.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class Traffic:
    """A generated mix: dataset records (detectron2 dicts, boxes xyxy in
    pixels, ``category_id`` a contiguous class id) and, for ``frames``, the
    decoded pixels by ``file_name``."""

    records: List[dict]
    pixels: Dict[str, np.ndarray] = field(default_factory=dict)

    def read_image(self, record: dict) -> np.ndarray:
        """The record's (H, W, 3) uint8 BGR pixels: the frame in memory, or
        the file decoded (cv2, as the program's transform reads it)."""
        if record["file_name"] in self.pixels:
            return self.pixels[record["file_name"]]
        import cv2

        return cv2.imread(record["file_name"], cv2.IMREAD_COLOR)


def counts_of(shares: Sequence[float], n: int) -> List[int]:
    """``n`` split by ``shares`` into whole counts that sum to ``n``
    (largest remainders)."""
    total = float(sum(shares))
    raw = [n * s / total for s in shares]
    out = [int(math.floor(r)) for r in raw]
    for i in sorted(range(len(raw)), key=lambda i: out[i] - raw[i])[: n - sum(out)]:
        out[i] += 1
    return out


def geometric_quantiles(n: int, mean: float, lo: int, hi: int) -> np.ndarray:
    """The ``n`` quantiles at (i + 0.5) / n of a geometric count on
    ``lo, lo + 1, ...`` with mean ``mean``, capped at ``hi``."""
    p = 1.0 / (mean - lo + 1.0)
    q = (np.arange(n) + 0.5) / n
    k = lo + np.floor(np.log1p(-q) / np.log1p(-p)).astype(np.int64)
    return np.clip(k, lo, hi)


def _background(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    import cv2

    coarse = rng.randint(0, 256, (max(2, h // 48), max(2, w // 48), 3)).astype(np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(img.astype(np.int16) + rng.randint(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)


def _boxes(rng: np.random.RandomState, n: int, h: int, w: int, spec: Dict[str, Any]) -> np.ndarray:
    lo = float(spec.get("min", 16))
    sides = []
    for extent in (w, h):
        hi = float(extent)
        sides.append(np.exp(rng.uniform(math.log(lo), math.log(max(hi, lo + 1.0)), n)))
    bw, bh = (np.minimum(s, e) for s, e in zip(sides, (w, h)))
    x1 = rng.uniform(0.0, 1.0, n) * (w - bw)
    y1 = rng.uniform(0.0, 1.0, n) * (h - bh)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float64)


def _classes(rng: np.random.RandomState, n: int, spec: Dict[str, Any]) -> np.ndarray:
    known, unknown = int(spec["known"]), int(spec.get("unknown", 0))
    share = float(spec.get("unknown_share", 0.0)) if unknown else 0.0
    is_unknown = rng.uniform(0.0, 1.0, n) < share
    return np.where(is_unknown, known + rng.randint(0, max(unknown, 1), n), rng.randint(0, known, n))


def sizes_of(spec: Dict[str, Any], rng: np.random.RandomState) -> List[tuple]:
    """The pool's (h, w) sizes: exact shares, in the seed's order."""
    sizes = [(int(h), int(w)) for h, w, _ in spec["sizes"]]
    counts = counts_of([s for _, _, s in spec["sizes"]], int(spec["pool"]))
    out = [hw for hw, c in zip(sizes, counts) for _ in range(c)]
    return [out[i] for i in rng.permutation(len(out))]


def generate(spec: Dict[str, Any], seed: int, directory: Optional[str] = None) -> Traffic:
    """The mix ``spec`` for ``seed``; ``image_files`` writes its pool under
    ``directory``."""
    rng = np.random.RandomState(np.random.SeedSequence([seed, 0x7AFF1C]).generate_state(4))
    kind = spec["kind"]
    if kind not in ("frames", "image_files"):
        raise ValueError(f"unknown traffic kind {kind!r}")
    sizes = sizes_of(spec, rng)
    gt = spec.get("gt_per_image")
    n_gt = np.zeros(len(sizes), np.int64)
    if gt is not None:
        n_gt = geometric_quantiles(len(sizes), float(gt["mean"]), int(gt.get("min", 1)), int(gt["max"]))
        n_gt = n_gt[rng.permutation(len(n_gt))]
    difficult = float(spec.get("difficult_share", 0.0))
    quality = int(spec.get("jpeg_quality", 90))
    if kind == "image_files":
        os.makedirs(directory, exist_ok=True)
    import cv2

    pixels, records = {}, []
    for i, ((h, w), n) in enumerate(zip(sizes, n_gt)):
        img = _background(rng, h, w)
        annos = []
        if n:
            boxes = _boxes(rng, int(n), h, w, spec["box_side"])
            classes = _classes(rng, int(n), spec["classes"])
            for b, c in zip(boxes, classes):
                x1, y1, x2, y2 = (int(round(v)) for v in b)
                img[y1:y2, x1:x2] = (img[y1:y2, x1:x2] // 3 + rng.randint(0, 170, 3)).astype(np.uint8)
                annos.append({"bbox": [float(v) for v in b], "category_id": int(c),
                              "difficult": int(rng.uniform() < difficult)})
        if kind == "frames":
            path = f"frame://{i}"
            pixels[path] = img
        else:
            path = os.path.join(directory, f"{i:05d}.jpg")
            if not cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, quality]):
                raise OSError(f"could not write {path}")
        records.append({"file_name": path, "image_id": i, "height": h, "width": w, "annotations": annos})
    return Traffic(records, pixels)


def cycle(records: Sequence[dict], start: int, count: int) -> List[dict]:
    """``count`` records taken in turn from ``start``, the pool cycled, each
    with an image id of its own (a pass larger than the pool evaluates the
    pool's files again as further images)."""
    out = []
    for k in range(count):
        rec = dict(records[(start + k) % len(records)])
        rec["image_id"] = start + k
        out.append(rec)
    return out
