"""Evaluation orchestration: the model's class-id maps from the dataset
catalog, the evaluator of a dataset, and ``do_test``.

Port of the eval half of ``openset_rcnn_tpu/engine/train_loop.py``
(``_known_dataset_meta :42``, ``build_model_spec :66``, ``get_evaluator
:96``, ``shard_eval_records :144``, ``do_test :152-240``). The training
loop (``do_train``) comes with the engine slice of the port.

``TPU.EVAL_MESH`` is read by the JAX package only: on one device it is a
no-op there too, and multi-process runs shard records per process here as
there.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data import DatasetCatalog, DetectionTransform, EvalLoader, MetadataCatalog

logger = logging.getLogger(__name__)


def known_dataset_meta(cfg, dataset_name: Optional[str] = None) -> Tuple[List[int], Dict[int, int]]:
    """(known dataset ids, dataset-id -> contiguous-id map) for the
    non-OpenDet (COCO) protocol. Datasets may declare their own open-set
    split via ``known_ids`` metadata (like the builtin GraspNet
    registration); the GraspNet tables are the fallback so reference
    configs work unregistered (ref prototype_learning_network.py:80-95)."""
    meta = None
    if dataset_name is None and cfg.DATASETS.TRAIN:
        dataset_name = cfg.DATASETS.TRAIN[0]
    if dataset_name is not None:
        try:
            meta = MetadataCatalog.get(dataset_name)
        except Exception:
            meta = None
    known_ids = meta.get("known_ids") if meta else None
    contig = meta.get("thing_dataset_id_to_contiguous_id") if meta else None
    if known_ids is None or contig is None:
        from ..data.graspnet_meta import GRASPNET_KNOWN_IDS, graspnet_metadata

        known_ids = GRASPNET_KNOWN_IDS
        contig = graspnet_metadata()["thing_dataset_id_to_contiguous_id"]
    return list(known_ids), dict(contig)


def build_id_map(cfg) -> List[int]:
    """Contiguous class id (+ background) -> known index or -1: the OpenDet
    map, or the known ids of the first training dataset (``build_model_spec``)."""
    from ..models.detector import known_ids_id_map, opendet_id_map

    num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    if cfg.OPENDET_BENCHMARK:
        return opendet_id_map(num_classes, cfg.MODEL.ROI_HEADS.NUM_KNOWN_CLASSES)
    known_ids, contig = known_dataset_meta(cfg)
    return known_ids_id_map(num_classes, [contig[i] for i in known_ids])


def class_id_table(cfg, dataset_name: Optional[str] = None) -> Optional[np.ndarray]:
    """Known index -> contiguous id of a test dataset (the first of
    ``cfg.DATASETS.TEST`` by default); None under the OpenDet protocol."""
    if cfg.OPENDET_BENCHMARK:
        return None
    if dataset_name is None and cfg.DATASETS.TEST:
        dataset_name = cfg.DATASETS.TEST[0]
    known_ids, contig = known_dataset_meta(cfg, dataset_name)
    return np.asarray(sorted(contig[i] for i in known_ids))


def get_evaluator(cfg, dataset_name: str, eval_type: str = "openset"):
    """Evaluator by dataset type (reference train.py:57-78)."""
    meta = MetadataCatalog.get(dataset_name)
    etype = meta.get("evaluator_type", "coco")
    if etype == "pascal_voc":
        from ..data.voc import load_voc_gt_for_eval
        from ..evaluation.voc_eval import OpensetVocEvaluator

        ev = OpensetVocEvaluator(
            class_names=meta.thing_classes,
            num_known_classes=cfg.MODEL.ROI_HEADS.NUM_KNOWN_CLASSES,
            output_dir=cfg.OUTPUT_DIR,
        )
        for g in load_voc_gt_for_eval(meta.dirname, meta.split):
            ev.add_ground_truth(g["image_id"], g["boxes"], g["class_names"], g["difficult"])
        return ev
    if etype == "voc_records":
        # GT supplied directly by dataset records (synthetic / custom sets).
        from ..evaluation.voc_eval import OpensetVocEvaluator

        ev = OpensetVocEvaluator(
            class_names=meta.thing_classes,
            num_known_classes=cfg.MODEL.ROI_HEADS.NUM_KNOWN_CLASSES,
            output_dir=cfg.OUTPUT_DIR,
        )
        for r in DatasetCatalog.get(dataset_name):
            annos = r.get("annotations", [])
            ev.add_ground_truth(
                r["image_id"],
                [a["bbox"] for a in annos],
                [meta.thing_classes[a["category_id"]] for a in annos],
                [bool(a.get("difficult", 0)) for a in annos],
            )
        return ev
    if etype == "coco":
        from ..evaluation.coco_eval import OpensetCocoEvaluator

        return OpensetCocoEvaluator(
            dataset_name,
            # datasets may declare their open-set split; GraspNet fallback
            known_ids=meta.get("known_ids", None),
            cfg=cfg,
            output_dir=os.path.join(cfg.OUTPUT_DIR, "inference", dataset_name),
            eval_type=eval_type,
        )
    raise ValueError(f"no evaluator for type {etype}")


def shard_eval_records(records, shard_id: int, num_shards: int):
    """Round-robin slice of the eval set for one process (d2
    InferenceSampler semantics: disjoint cover, every index assigned)."""
    if num_shards <= 1:
        return records
    return records[shard_id::num_shards]


def build_test_transform(cfg) -> DetectionTransform:
    return DetectionTransform(
        min_sizes=(cfg.INPUT.MIN_SIZE_TEST,),
        max_size=cfg.INPUT.MAX_SIZE_TEST,
        bucket_hw=tuple(cfg.TPU.TEST_BUCKET),
        max_gt=cfg.TPU.MAX_GT_PER_IMAGE,
        flip=False,
        fmt=cfg.INPUT.FORMAT,
        interp=cfg.TPU.RESIZE_INTERP,
    )


def do_test(cfg, state_dict: Optional[Mapping[str, torch.Tensor]] = None, datasets: Optional[Sequence[str]] = None,
            eval_type: str = "openset", device: Optional[Union[str, torch.device]] = None, seed: int = 0,
            transform: Optional[DetectionTransform] = None) -> Dict[str, Dict[str, float]]:
    """Evaluate the model of ``cfg`` with ``state_dict`` (a seeded random
    init when None) on ``datasets`` (``cfg.DATASETS.TEST`` by default):
    {dataset: metrics}.

    ``eval_type="proposals"`` scores the RPN's proposals by AR; otherwise
    the open-set detections go to the dataset's evaluator, through the fused
    device cascade, or through the exact host cascade under
    ``TPU.EVAL_FUSED false``. ``device``: the GPU unless given (``"cpu"``
    runs the plain versions of the kernels). ``transform``: the test
    transform (built from ``cfg`` when None), e.g. one whose ``read_image``
    supplies decoded images.
    """
    from ..evaluation.inference import Predictor, ProposalPredictor
    from ..evaluation.postprocess import PostprocessConfig
    from ..evaluation.testing import inference_on_dataset, proposal_ar_on_dataset
    from ..parallel import num_processes, process_index

    names = list(datasets or cfg.DATASETS.TEST)
    transform = transform or build_test_transform(cfg)
    results = {}
    if eval_type == "proposals":
        # box-proposals AR task (reference os_coco_evaluation.py:297-334):
        # backbone + CF-RPN proposals only, scored against all GT pooled
        infer = ProposalPredictor(cfg, device, state_dict, seed)
        for name in names:
            records = DatasetCatalog.get(name)
            shard = shard_eval_records(records, process_index(), num_processes())
            loader = EvalLoader(shard, transform, batch_size=cfg.TPU.EVAL_BATCH_SIZE)
            logger.info("proposal-AR eval on %s (%d images)", name, len(shard))
            results[name] = proposal_ar_on_dataset(infer, loader, records)
        return results

    post_cfg = PostprocessConfig.from_cfg(cfg, cfg.OPENDET_BENCHMARK, class_id_table(cfg, names[0]))
    predictor = Predictor(cfg, device, state_dict, seed, post_cfg=post_cfg)
    for name in names:
        # Multi-process eval sharding: each process infers a round-robin
        # slice; the evaluators' evaluate() gathers detections across
        # processes (reference d2 InferenceSampler + comm.gather).
        records = shard_eval_records(DatasetCatalog.get(name), process_index(), num_processes())
        loader = EvalLoader(records, transform, batch_size=cfg.TPU.EVAL_BATCH_SIZE)
        evaluator = get_evaluator(cfg, name, eval_type)
        logger.info("evaluating %s (%d images)", name, len(records))
        results[name] = inference_on_dataset(predictor, loader, evaluator, fused=cfg.TPU.EVAL_FUSED)
    return results
