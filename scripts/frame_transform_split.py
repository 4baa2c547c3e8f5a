"""The frame path's test transform, piece by piece, on 1280x720 frames.

    python3 scripts/frame_transform_split.py [--frames 100] [--seed 0]

Builds the test transform of ``configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml``
(shortest side 800, cap 1333, bucket 832x1344, PIL's BILINEAR) and times, on
seeded random frames at the frames cell's size, the median milliseconds of:

* the PIL route, as ``resize_image`` and ``DetectionTransform`` ran it before
  the native resize: ``Image.fromarray``, ``Image.resize``, ``np.asarray``,
  the zeroed bucket and the copy into it, and the four in a row;
* the native resize straight into the bucket (``resize_native.resize``);
* ``DetectionTransform`` whole (no read), on the native route and with the
  native library hidden (the PIL route).

Every frame's native bucket is checked bitwise against the installed
Pillow's. Prints one JSON line with the host's CPU, Pillow's version and the
card's name and power limit where ``nvidia-smi`` answers. Imports the port
only (no JAX); needs no card.
"""
import argparse
import json
import os
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FRAME_HW = (720, 1280)


def cpu_model() -> str:
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "none"


def median_ms(fn, frames):
    times = []
    for f in frames:
        t = time.perf_counter()
        fn(f)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from PIL import Image, __version__ as pillow

    from openset_rcnn_tpu_torch.config import get_default_cfg
    from openset_rcnn_tpu_torch.data import resize_native
    from openset_rcnn_tpu_torch.engine.train_loop import build_test_transform

    root = Path(__file__).resolve().parent.parent
    cfg = get_default_cfg()
    cfg.merge_from_file(str(root / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml"))
    transform = build_test_transform(cfg)
    transform.read_image = lambda record: record["pixels"]
    rng = np.random.default_rng(args.seed)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(args.frames)]
    records = [{"image_id": i, "pixels": f} for i, f in enumerate(frames)]
    t = time.perf_counter()
    built = resize_native.library() is not None
    load_ms = (time.perf_counter() - t) * 1e3
    ex = transform(records[0], np.random.RandomState(0))
    (nh, nw), (bh, bw) = ex.image_hw, ex.bucket_hw

    def zeros_and_copy(a):
        padded = np.zeros((bh, bw, 3), np.uint8)
        padded[:nh, :nw] = a
        return padded

    def pil_bucket(f):
        return zeros_and_copy(np.asarray(Image.fromarray(f).resize((nw, nh), Image.BILINEAR)))

    for f in frames:
        if not np.array_equal(resize_native.resize(f, nh, nw, (bh, bw)), pil_bucket(f)):
            raise SystemExit("native resize differs from PIL's")

    images = [Image.fromarray(f) for f in frames]
    resized = [im.resize((nw, nh), Image.BILINEAR) for im in images]
    arrays = [np.asarray(r) for r in resized]
    ms = {
        "pil.fromarray": median_ms(Image.fromarray, frames),
        "pil.resize": median_ms(lambda im: im.resize((nw, nh), Image.BILINEAR), images),
        "pil.asarray": median_ms(np.asarray, resized),
        "pil.zeros_and_copy": median_ms(zeros_and_copy, arrays),
        "pil.whole": median_ms(pil_bucket, frames),
        "native.resize_into_bucket": median_ms(lambda f: resize_native.resize(f, nh, nw, (bh, bw)), frames),
        "transform.native": median_ms(lambda r: transform(r, np.random.RandomState(0)), records),
    }
    library = resize_native.library
    resize_native.library = lambda: None
    try:
        ms["transform.pil"] = median_ms(lambda r: transform(r, np.random.RandomState(0)), records)
    finally:
        resize_native.library = library
    print(json.dumps({
        "frames": args.frames, "frame_hw": FRAME_HW, "resized_hw": (nh, nw), "bucket_hw": (bh, bw),
        "bitwise_pil": True, "native_built": built, "load_ms": round(load_ms, 3),
        "median_ms": {k: round(v, 3) for k, v in ms.items()},
        "pillow": pillow, "numpy": np.__version__, "cpu": cpu_model(), "cores": os.cpu_count(), "card": card(),
    }))


if __name__ == "__main__":
    main()
