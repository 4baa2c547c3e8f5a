"""Built-in dataset registration.

Copy of ``openset_rcnn_tpu/data/builtin.py``, kept in the port so
that it imports nothing of the JAX package.

Registers the same dataset names the reference registers at import time
(data/custom.py:9-52): 7 GraspNet-OS splits, 8 VOC-COCO open-set test
splits, plus the plain VOC trainval/test splits the VOC-COCO config trains
on. Root directory comes from $DETECTRON2_DATASETS (same env var contract).
Registration is lazy — loaders only touch the filesystem when a dataset is
actually requested.
"""
from __future__ import annotations

import os
from functools import partial

from .catalog import DatasetCatalog, MetadataCatalog
from .coco import load_coco_instances
from .graspnet_meta import GRASPNET_KNOWN_IDS, graspnet_metadata
from .voc import VOC_COCO_CATEGORIES, load_voc_instances

_GRASPNET_SPLITS = {
    "graspnet_train": ("graspnet/images", "graspnet/annotations/graspnet_train.json"),
    **{
        f"graspnet_test_{i}": (
            "graspnet/images",
            f"graspnet/annotations/graspnet_test_{i}.json",
        )
        for i in range(1, 7)
    },
}

_VOC_COCO_TEST_SPLITS = [
    "voc_coco_20_40_test",
    "voc_coco_20_60_test",
    "voc_coco_20_80_test",
    "voc_coco_2500_test",
    "voc_coco_5000_test",
    "voc_coco_10000_test",
    "voc_coco_20000_test",
    "voc_coco_val",
]

_VOC_SPLITS = {
    "voc_2007_train": ("VOC2007", "train"),
    "voc_2007_val": ("VOC2007", "val"),
    "voc_2007_trainval": ("VOC2007", "trainval"),
    "voc_2007_test": ("VOC2007", "test"),
    "voc_2012_train": ("VOC2012", "train"),
    "voc_2012_trainval": ("VOC2012", "trainval"),
}


def register_graspnet_os(root: str):
    """GraspNet-OS: COCO-json datasets; the TRAIN split keeps only known-
    category annotations (data/graspnet.py:190-195)."""
    meta = graspnet_metadata()
    for name, (image_dir, json_file) in _GRASPNET_SPLITS.items():
        keep = GRASPNET_KNOWN_IDS if "train" in name else None
        DatasetCatalog.register(
            name,
            partial(
                load_coco_instances,
                os.path.join(root, json_file),
                os.path.join(root, image_dir),
                dataset_name=name,
                keep_category_ids=keep,
                id_to_contiguous=meta["thing_dataset_id_to_contiguous_id"],
            ),
        )
        MetadataCatalog.get(name).set(
            evaluator_type="coco",
            json_file=os.path.join(root, json_file),
            image_root=os.path.join(root, image_dir),
            known_ids=list(GRASPNET_KNOWN_IDS),
            **meta,
        )


def register_opendet_voc_coco(root: str):
    """VOC-COCO OpenDet protocol: VOC-XML-backed datasets with the 81-name
    class list (data/voc_coco.py:30-40)."""
    # plain VOC train/test splits (training data: VOC classes only)
    for name, (year_dir, split) in _VOC_SPLITS.items():
        dirname = os.path.join(root, year_dir)
        DatasetCatalog.register(
            name, partial(load_voc_instances, dirname, split, VOC_COCO_CATEGORIES)
        )
        MetadataCatalog.get(name).set(
            evaluator_type="pascal_voc",
            dirname=dirname,
            split=split,
            thing_classes=VOC_COCO_CATEGORIES,
        )
    # open-set test splits live under voc_coco/
    dirname = os.path.join(root, "voc_coco")
    for split in _VOC_COCO_TEST_SPLITS:
        DatasetCatalog.register(
            split, partial(load_voc_instances, dirname, split, VOC_COCO_CATEGORIES)
        )
        MetadataCatalog.get(split).set(
            evaluator_type="pascal_voc",
            dirname=dirname,
            split=split,
            thing_classes=VOC_COCO_CATEGORIES,
        )


_REGISTERED = False


def register_builtin_datasets(root: str | None = None):
    global _REGISTERED
    if _REGISTERED:
        return
    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")
    register_graspnet_os(root)
    register_opendet_voc_coco(root)
    _REGISTERED = True
