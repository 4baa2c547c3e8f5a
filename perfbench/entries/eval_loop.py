"""The dataset-evaluation window: whole passes of
``inference_on_dataset(Predictor, EvalLoader, <the open-set VOC evaluator>,
fused=True)``, as ``do_test`` runs them, the evaluator built and its
``evaluate()`` run in every pass.

Each pass takes the cell's ``images_per_pass`` records, the traffic's pool
cycled from where the last pass stopped (each record an image of its own).
Set-up warms up both buckets with a short pass. The window runs passes until
one ends after ``--seconds``: ``eval_img_per_s`` is every image of those
passes over their whole time. Once it has closed and the predictor is freed,
``sample`` images drawn from the seed among those the window evaluated go
through the reference (its transform, its detector, its cascade and
rescale) and each image's detections are compared with the program's; the
reference's copy of the evaluator scores the last pass's detections as the
program gave them, against the program's evaluator.

Traced: the stage marks of every batch on CUDA events (through a thin
wrapper that passes ``mark`` to ``Predictor``), the loop's own
``timings``, and a profiler stretch of ``PROFILED_BATCHES`` batches.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.harness import compare, prepare, traffic
from perfbench.harness.core import Run, peak_memory, program_cfg, release, sync
from perfbench.harness.trace import Marks, Profile

WARM_IMAGES_PER_BUCKET = 16
PROFILE_AFTER = 8     # batches into the traced window before the profiled stretch
PROFILED_BATCHES = 8


class Recorder:
    """The evaluator with every image's detections kept on the way in."""

    def __init__(self, evaluator):
        self.evaluator, self.dets = evaluator, {}

    def reset(self):
        self.evaluator.reset()

    def process(self, image_id, boxes, scores, classes):
        self.dets[image_id] = (np.array(boxes), np.array(scores), np.array(classes))
        self.evaluator.process(image_id, boxes, scores, classes)

    def evaluate(self):
        return self.evaluator.evaluate()


class Traced:
    """``Predictor`` with its stage marks on CUDA events, and the profiled
    stretch started and stopped between batches."""

    def __init__(self, predictor, marks: Marks, profile: Profile):
        self.p, self.marks, self.profile, self.batches = predictor, marks, profile, 0
        self.post_cfg, self.device = predictor.post_cfg, predictor.device

    def __call__(self, images, image_hw):
        if self.batches == PROFILE_AFTER:
            self.profile.start()
        if self.batches == PROFILE_AFTER + PROFILED_BATCHES and self.profile.active:
            self.profile.stop()
        self.batches += 1
        self.marks.begin()
        return self.p(images, image_hw, mark=self.marks)

    def raw(self, images, image_hw):
        return self.p.raw(images, image_hw)


def one_pass(s: dict, records, name: str, predictor, timings=None):
    """``do_test``'s body for one dataset of ``records``: register, build
    the evaluator, run ``inference_on_dataset``. (metrics, detections)."""
    from openset_rcnn_tpu_torch.data import DatasetCatalog, EvalLoader, MetadataCatalog, VOC_COCO_CATEGORIES
    from openset_rcnn_tpu_torch.engine.train_loop import get_evaluator
    from openset_rcnn_tpu_torch.evaluation.testing import inference_on_dataset

    cfg = s["cfg"]
    DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: records)
    MetadataCatalog.get(name).update(evaluator_type="voc_records", thing_classes=VOC_COCO_CATEGORIES)
    evaluator = Recorder(get_evaluator(cfg, name))
    loader = EvalLoader(records, s["transform"], batch_size=cfg.TPU.EVAL_BATCH_SIZE)
    metrics = inference_on_dataset(predictor, loader, evaluator, fused=cfg.TPU.EVAL_FUSED, timings=timings)
    return metrics, evaluator.dets


def setup(r: Run) -> dict:
    from openset_rcnn_tpu_torch.engine.train_loop import build_test_transform
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor
    from openset_rcnn_tpu_torch.evaluation.postprocess import PostprocessConfig

    cfg = program_cfg(r.config)
    data = prepare.make_traffic(r)
    weights = prepare.weights(r, data)
    predictor = Predictor(cfg, r.device, state_dict=weights,
                          post_cfg=PostprocessConfig.from_cfg(cfg, cfg.OPENDET_BENCHMARK, None))
    transform = build_test_transform(cfg)
    s = {"cfg": cfg, "data": data, "weights": weights, "predictor": predictor, "transform": transform}
    landscape = [rec for rec in data.records if rec["width"] >= rec["height"]][:WARM_IMAGES_PER_BUCKET]
    portrait = [rec for rec in data.records if rec["width"] < rec["height"]][:WARM_IMAGES_PER_BUCKET]
    one_pass(s, traffic.cycle(landscape + portrait, 0, len(landscape) + len(portrait)), "perfbench_warm", predictor)
    return s


def window(r: Run, s: dict) -> None:
    per_pass = int(r.cell["images_per_pass"])
    records = s["data"].records
    predictor = s["predictor"]
    if r.trace:
        marks, profile = Marks(), Profile()
        predictor = Traced(predictor, marks, profile)
    timings_all = {"wait_ms": [], "consume_ms": []}
    passes, images, start = [], 0, 0
    t0 = time.perf_counter()
    while True:
        timings = {}
        metrics, dets = one_pass(s, traffic.cycle(records, start, per_pass), f"perfbench_pass{len(passes)}",
                                 predictor, timings)
        passes.append({"records": traffic.cycle(records, start, per_pass), "metrics": metrics, "dets": dets})
        images += timings["images"]
        for k in timings_all:
            timings_all[k] += timings[k]
        start += per_pass
        if time.perf_counter() - t0 >= r.seconds and not (r.trace and profile.active):
            break
    sync()
    elapsed = time.perf_counter() - t0
    r.e2e["eval_img_per_s"] = images / elapsed
    r.attempted = images
    r.failed = images - sum(len(p["dets"]) for p in passes)
    r.memory_peak_bytes = peak_memory(r.device)
    r.notes["passes"] = len(passes)
    s["passes"] = passes
    if r.trace:
        r.profile = profile.summary()
        r.per_layer_inputs.update(marks=marks, timings=timings_all, window_s=elapsed, images=images,
                                  batch=s["cfg"].TPU.EVAL_BATCH_SIZE)


def _reference_dets(r: Run, s: dict, ref, records) -> dict:
    """image id -> the reference ``ref``'s detections on ``records``."""
    transform = prepare.reference_transform(r.config["cfg"], train=False)
    transform.read_image = s["data"].read_image
    out = {}
    for rec in records:
        ex = transform(rec, np.random.RandomState(0))
        out[rec["image_id"]] = prepare.dets_dict(ref.detect(ex.image, ex.image_hw, ex.original_hw))
    return out


def detection_checks(r: Run, s: dict, prog: dict, records, control: str = None) -> dict:
    """The numbers of the program's detections ``prog`` (image id ->
    (boxes, scores, classes)) against the reference's on ``records``
    (``harness/compare.py``); with ``control`` (a precision) the reference
    in that precision stands in for the program."""
    from perfbench.reference.model import Reference

    ref = Reference(r.config["cfg"], s["weights"], r.device)
    want = _reference_dets(r, s, ref, records)
    if control is not None:
        low = Reference(r.config["cfg"], s["weights"], r.device, control)
        prog = {k: (v["boxes"], v["scores"], v["classes"]) for k, v in _reference_dets(r, s, low, records).items()}
    known, unknown = prepare.thresholds(r.config["cfg"])
    per_image = []
    for rec in records:
        b, sc, c = prog[rec["image_id"]]
        got = {"boxes": np.asarray(b, np.float64).reshape(-1, 4), "scores": np.asarray(sc, np.float64),
               "classes": np.asarray(c, np.int64)}
        per_image.append(compare.detection_numbers(got, want[rec["image_id"]], ref.post.unknown_id, known, unknown))
    return compare.widest(per_image)


def evaluator_check(r: Run, s: dict) -> float:
    """The reference evaluator over the last pass's detections as the
    program gave them, against the program's evaluator's metrics."""
    from perfbench.reference.data.categories import VOC_COCO_CATEGORIES
    from perfbench.reference.evaluation.voc_eval import OpensetVocEvaluator

    last = s["passes"][-1]
    names = list(VOC_COCO_CATEGORIES)
    ev = OpensetVocEvaluator(class_names=names, num_known_classes=r.config["cfg"]["MODEL"]["ROI_HEADS"]["NUM_KNOWN_CLASSES"])
    for rec in last["records"]:
        annos = rec["annotations"]
        ev.add_ground_truth(rec["image_id"], [a["bbox"] for a in annos], [names[a["category_id"]] for a in annos],
                            [bool(a.get("difficult", 0)) for a in annos])
    for image_id, (b, sc, c) in last["dets"].items():
        ev.process(image_id, b, sc, c)
    return compare.evaluator_gap(last["metrics"], ev.evaluate())


def numbers(r: Run, s: dict, control: str = None) -> dict:
    """The numbers of ``sample`` evaluated images drawn from the seed, and
    the evaluator's gap (0 where ``control`` stands in, since the program's
    evaluator is then the reference's); the last pass's metrics beside
    them."""
    evaluated = [rec for p in s["passes"] for rec in p["records"]]
    dets = {k: v for p in s["passes"] for k, v in p["dets"].items()}
    records = prepare.sample(r, evaluated, int(r.cell["sample"]), "sample")
    numbers = detection_checks(r, s, dets, records, control)
    numbers["evaluator_gap"] = evaluator_check(r, s) if control is None else 0.0
    numbers["last_pass_metrics"] = s["passes"][-1]["metrics"]
    return numbers


def free(s: dict) -> None:
    s.pop("predictor", None)
    release()
