"""Dataset catalogs, readers, transforms and the evaluation loader.

The port's counterpart of ``openset_rcnn_tpu/data/``; the training loader
comes with the training loop.
"""
from .catalog import DatasetCatalog, MetadataCatalog
from .builtin import register_builtin_datasets, register_graspnet_os, register_opendet_voc_coco
from .transforms import DetectionTransform, resize_shortest_edge
from .loader import BatchMeta, EvalLoader, collate, device_prefetch
from .voc import VOC_CLASSES, VOC_COCO_CATEGORIES, load_voc_instances
from .coco import CocoJson, load_coco_instances
from .graspnet_meta import (
    GRASPNET_CATEGORIES,
    GRASPNET_KNOWN_CATEGORIES,
    GRASPNET_KNOWN_IDS,
    graspnet_metadata,
)
from .synthetic import generate_synthetic_dataset
