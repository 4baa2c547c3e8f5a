"""Open-set inference on image files or folders:

    python -m openset_rcnn_tpu_torch.tools.predict \\
        --config-file configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml \\
        --input img1.jpg img2.jpg --output out/ [--viz] \\
        MODEL.WEIGHTS path/to/weights.pth

Port of ``tools/predict.py``: ``Predictor`` (on the GPU; ``main(...,
device="cpu")`` runs the plain versions on the CPU) with ``MODEL.WEIGHTS``
(any format ``engine.checkpoint.load_weights_file`` reads; a seeded random
init when empty), the test-time ``DetectionTransform``, one image a batch,
and ``finalize_serve_image``. Writes one JSON per image (``file_name``,
``boxes_xyxy`` rounded to 2 decimals, ``scores`` to 4, ``classes``,
``names``) and, with ``--viz``, a BGR overlay ``<name>_viz.jpg`` (unknowns
in red). Class names and the known-index -> contiguous-id table are
GraspNet's unless ``OPENDET_BENCHMARK`` is true, as in the JAX tool.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="open-set detections of image files (PyTorch port)")
    p.add_argument("--config-file", required=True)
    p.add_argument("--input", nargs="+", required=True, help="image files or a directory")
    p.add_argument("--output", default="predictions")
    p.add_argument("--viz", action="store_true", help="also write box overlays")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p


def serving_classes(cfg) -> Tuple[Optional[List[str]], Optional[np.ndarray]]:
    """(class names by final class id, known index -> contiguous id table):
    the first test dataset's names under ``OPENDET_BENCHMARK``, GraspNet's
    names and table otherwise (``tools/predict.py:66-77``)."""
    if cfg.OPENDET_BENCHMARK:
        from ..data import MetadataCatalog

        return (MetadataCatalog.get(cfg.DATASETS.TEST[0]).thing_classes if cfg.DATASETS.TEST else None), None
    from ..data.graspnet_meta import GRASPNET_KNOWN_IDS, graspnet_metadata

    meta = graspnet_metadata()
    contig = meta["thing_dataset_id_to_contiguous_id"]
    return meta["thing_classes"], np.asarray(sorted(contig[i] for i in GRASPNET_KNOWN_IDS))


def image_paths(inputs: Sequence[str]) -> List[str]:
    paths = []
    for item in inputs:
        if os.path.isdir(item):
            paths.extend(os.path.join(item, f) for f in sorted(os.listdir(item))
                         if f.lower().endswith(IMAGE_SUFFIXES))
        else:
            paths.append(item)
    return paths


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> Dict[str, dict]:
    """Predict every input image; returns {image path: its JSON record}.
    ``device``: the GPU unless given."""
    args = get_parser().parse_args(argv)

    from ..config import get_default_cfg
    from ..data import DetectionTransform, register_builtin_datasets
    from ..engine.checkpoint import load_weights_file
    from ..evaluation.inference import Predictor
    from ..evaluation.postprocess import PostprocessConfig, finalize_serve_image

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    register_builtin_datasets()

    names, table = serving_classes(cfg)
    post_cfg = PostprocessConfig.from_cfg(cfg, cfg.OPENDET_BENCHMARK, table)
    predictor = Predictor(cfg, device, seed=max(cfg.SEED, 0), post_cfg=post_cfg)
    if cfg.MODEL.WEIGHTS:
        load_weights_file(cfg.MODEL.WEIGHTS, predictor.model)
    transform = DetectionTransform(min_sizes=(cfg.INPUT.MIN_SIZE_TEST,), max_size=cfg.INPUT.MAX_SIZE_TEST,
                                   bucket_hw=tuple(cfg.TPU.TEST_BUCKET), max_gt=1, flip=False,
                                   fmt=cfg.INPUT.FORMAT, interp=cfg.TPU.RESIZE_INTERP)

    os.makedirs(args.output, exist_ok=True)
    rng = np.random.RandomState(0)
    results = {}
    for path in image_paths(args.input):
        ex = transform({"file_name": path, "image_id": path}, rng)
        if ex is None:
            print(f"skipping unreadable {path}")
            continue
        out = predictor(torch.from_numpy(ex.image[None]), torch.tensor([ex.image_hw], dtype=torch.float32))
        dets = finalize_serve_image(out.boxes[0].cpu().numpy(), out.scores[0].cpu().numpy(),
                                    out.classes[0].cpu().numpy(), out.valid[0].cpu().numpy(),
                                    ex.image_hw, ex.original_hw, post_cfg)
        det_names = ["unknown" if int(c) == post_cfg.unknown_id else (names[int(c)] if names else str(int(c)))
                     for c in dets.classes]
        record = {
            "file_name": path,
            "boxes_xyxy": np.asarray(dets.boxes).round(2).tolist(),
            "scores": np.asarray(dets.scores).round(4).tolist(),
            "classes": np.asarray(dets.classes).tolist(),
            "names": det_names,
        }
        base = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(args.output, base + ".json"), "w") as f:
            json.dump(record, f, indent=1)
        if args.viz:
            import cv2

            from ..utils.visualizer import draw_boxes

            overlay = draw_boxes(cv2.imread(path, cv2.IMREAD_COLOR), dets.boxes, labels=det_names,
                                 classes=np.asarray(dets.classes), scores=np.asarray(dets.scores),
                                 unknown_id=post_cfg.unknown_id)
            cv2.imwrite(os.path.join(args.output, base + "_viz.jpg"), overlay)
        results[path] = record
        print(f"{path}: {len(det_names)} detections -> {args.output}/{base}.json")
    return results


if __name__ == "__main__":
    main()
