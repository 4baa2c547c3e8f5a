"""Training and evaluation orchestration: the model's class-id maps from
the dataset catalog, the evaluator of a dataset, ``do_test`` and
``do_train``.

Port of ``openset_rcnn_tpu/engine/train_loop.py`` (``_known_dataset_meta
:42``, ``build_model_spec :66``, ``load_train_records :89``,
``get_evaluator :96``, ``shard_eval_records :144``, ``do_test :152-240``,
``do_train :243-417``). ``do_train`` keeps the JAX loop's semantics: a
negative ``SEED`` draws a fresh seed, the loader's seed is ``max(SEED, 0)``,
metrics are written at every 20th iteration, at ``MAX_ITER`` and at the
first iteration of a run, a checkpoint every ``CHECKPOINT_PERIOD`` and at
the end, ``do_test`` every ``TEST.EVAL_PERIOD`` but at ``MAX_ITER``. A
resumed run restores step, parameters and momentum, and its loader starts
again at epoch 0, as JAX's does.

Several GPUs: one process per GPU (``python -m openset_rcnn_tpu_torch.train
--num-gpus N``, or torchrun), laid out as ``TPU.MESH_DATA x TPU.MESH_MODEL``
(``parallel/mesh.py``, the twin of JAX's mesh at ``train_loop.py:272-311``).
``do_train`` splits each global batch of ``SOLVER.IMS_PER_BATCH`` images over
the data axis (``TrainLoader`` shards, ``:323-336``), reduces gradients with
``DistributedDataParallel`` and shards the box head over the model axis;
it trains as one process does at the same global batch, up to the order of
float sums. Rank 0 writes metrics and the gathered checkpoints, and every rank
evaluates with the gathered weights (``:399-408``). ``do_test`` shards the
records over the processes and the evaluators gather the detections.
``TPU.EVAL_MESH``, with which one JAX process splits its eval batch over its
local chips (``:167-183``), has no twin here: the port drives one GPU per
process, so ``--eval-only --num-gpus N`` evaluates on N processes instead.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data import DatasetCatalog, DetectionTransform, EvalLoader, MetadataCatalog, TrainLoader
from ..utils import tracing

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


def load_train_records(cfg) -> List[dict]:
    records = []
    for name in cfg.DATASETS.TRAIN:
        records.extend(DatasetCatalog.get(name))
    return records


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


def build_train_transform(cfg) -> DetectionTransform:
    return DetectionTransform(
        min_sizes=tuple(cfg.INPUT.MIN_SIZE_TRAIN),
        max_size=cfg.INPUT.MAX_SIZE_TRAIN,
        bucket_hw=tuple(cfg.TPU.TRAIN_BUCKET),
        max_gt=cfg.TPU.MAX_GT_PER_IMAGE,
        flip=cfg.INPUT.RANDOM_FLIP == "horizontal",
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

    Under a process group each process infers every N-th record (N
    processes) and the evaluators gather the detections, so every process
    returns the metrics of the whole dataset; this is the port's
    ``TPU.EVAL_MESH`` (see the module's docstring).
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


def do_train(cfg, resume: bool = False, profile_steps: int = 0, debug_nans: bool = False,
             device: Optional[Union[str, torch.device]] = None):
    """Train the model of ``cfg`` on ``cfg.DATASETS.TRAIN`` from a seeded
    random init, ``MODEL.WEIGHTS`` or (``resume``) the latest checkpoint of
    ``OUTPUT_DIR``, to ``SOLVER.MAX_ITER``; returns the ``TrainState``.

    Args:
        profile_steps: if > 0, a ``torch.profiler`` trace of that many steps
            (after 5 warm-up steps) into ``OUTPUT_DIR/profile``, with the
            program's spans of those steps (``utils/tracing.py``: the loader
            threads, ``train.step`` and its stages) on the same timeline, and
            the device's idle seconds by span in the log.
        debug_nans: run under ``torch.autograd.detect_anomaly``, which names
            the op whose backward produced a NaN (much slower; debug only).
        device: the GPU unless given (``"cpu"`` runs the plain versions of
            the kernels); with no GPU and no device it raises.

    Every rank of a process group calls it (``parallel.launch``); outside a
    group ``TPU.MESH_DATA x TPU.MESH_MODEL`` must be 1, and a product that
    does not lay out the group raises ``ValueError`` (``make_layout``).
    """
    import contextlib
    import time

    from ..data import device_prefetch, register_builtin_datasets
    from ..device import resolve_device
    from ..parallel import gather_object
    from ..parallel.mesh import gather_state_dict, make_layout
    from .checkpoint import Checkpointer
    from .events import EventWriter
    from .train_state import Trainer

    device = resolve_device(device)
    if cfg.SEED < 0:
        # d2 semantics: negative seed -> fresh random seed per run
        seed = (int(time.time() * 1000) ^ os.getpid()) % (2**31)
        seed = gather_object(seed)[0]  # every rank takes rank 0's
        cfg = cfg.clone()
        cfg.SEED = seed
        cfg.freeze()
        logger.info("using random seed %d", seed)
    layout = make_layout(cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL)
    if cfg.SOLVER.IMS_PER_BATCH % layout.data:
        raise ValueError(f"SOLVER.IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} does not split over {layout.data} "
                         "data-parallel processes")
    register_builtin_datasets()
    seed = max(cfg.SEED, 0)
    trainer = Trainer(cfg, device, seed=seed, layout=layout)
    checkpointer = Checkpointer(cfg.OUTPUT_DIR, layout)
    checkpointer.resume_or_load(trainer.state, cfg.MODEL.WEIGHTS, resume)
    start_iter = trainer.state.step
    if layout.distributed:
        logger.info("training as rank (data %d, model %d) of a %d x %d layout", layout.data_index,
                    layout.model_index, layout.data, layout.model)

    loader = TrainLoader(
        load_train_records(cfg),
        build_train_transform(cfg),
        batch_size=cfg.SOLVER.IMS_PER_BATCH // layout.data,
        seed=seed,
        shard_id=layout.data_index,
        num_shards=layout.data,
        filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS,
        num_workers=cfg.DATALOADER.NUM_WORKERS,
    )
    writer = EventWriter(cfg.OUTPUT_DIR)
    max_iter = cfg.SOLVER.MAX_ITER
    ckpt_period = cfg.SOLVER.CHECKPOINT_PERIOD
    eval_period = cfg.TEST.EVAL_PERIOD
    logger.info("starting training at iter %d (max %d)", start_iter, max_iter)

    profile_dir = os.path.join(cfg.OUTPUT_DIR, "profile")
    profile_start = start_iter + 5 if profile_steps > 0 else -1
    profiler = None
    anomaly = torch.autograd.detect_anomaly(check_nan=True) if debug_nans else contextlib.nullcontext()

    it = start_iter
    with anomaly:
        for batch, meta in device_prefetch(iter(loader), device):
            if it >= max_iter:
                break
            if it == profile_start and profiler is None:
                profiler = _start_profiler(device)
            metrics = trainer.step(batch)
            it = trainer.state.step
            if profiler is not None and it >= profile_start + profile_steps:
                _stop_profiler(profiler, device, profile_dir)
                profiler = None

            if it % 20 == 0 or it == max_iter or it == start_iter + 1:
                host_metrics = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(host_metrics["total_loss"]):
                    raise FloatingPointError(f"non-finite loss at iter {it}: {host_metrics}")
                writer.write(it, host_metrics)

            if ckpt_period and it % ckpt_period == 0:
                checkpointer.save(trainer.state, it)
            if eval_period and it % eval_period == 0 and it != max_iter:
                weights = gather_state_dict(trainer.model.state_dict(), layout)
                results = do_test(cfg, weights, device=device, seed=seed)
                for ds, res in results.items():
                    writer.write(it, {f"{ds}/{k}": v for k, v in res.items() if np.isscalar(v)})
        if profiler is not None:
            _stop_profiler(profiler, device, profile_dir)

    checkpointer.save(trainer.state, it)
    writer.close()
    return trainer.state


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=activities)
    prof.__enter__()
    tracing.enable()
    return prof


def _stop_profiler(prof, device: torch.device, profile_dir: str) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    snap = tracing.snapshot()
    tracing.disable()
    prof.__exit__(None, None, None)
    from ..parallel import process_index

    os.makedirs(profile_dir, exist_ok=True)
    rank = process_index()
    path = os.path.join(profile_dir, "trace.json" if rank == 0 else f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    tracing.add_to_chrome_trace(path, snap)
    logger.info("profiler trace written to %s (program spans: %d)", path, len(snap["spans"]))
    gaps = tracing.device_gaps(prof)
    if gaps:
        logger.info("device idle seconds by program span: %s",
                    {k: round(v, 6) for k, v in tracing.idle_by_span(gaps, snap).items()})
