"""The port's tracer (``openset_rcnn_tpu_torch/utils/tracing.py``): off by
default, spans and counters when on, at the loader, the predictor, the
training step's stages, the eval loop and ``do_train --profile-steps``, and
on ``torch.profiler``'s clock.

Imports nothing of the JAX package, so the test marked ``cuda`` runs on a
machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_tracing.py
"""
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from openset_rcnn_tpu_torch.config import get_default_cfg
from openset_rcnn_tpu_torch.data import DatasetCatalog, EvalLoader, MetadataCatalog, TrainLoader, collate
from openset_rcnn_tpu_torch.data.synthetic import generate_synthetic_dataset
from openset_rcnn_tpu_torch.data.transforms import DetectionTransform
from openset_rcnn_tpu_torch.engine import train_loop
from openset_rcnn_tpu_torch.evaluation.inference import Predictor
from openset_rcnn_tpu_torch.evaluation.testing import SERVE_FIELDS, inference_on_dataset, to_host
from openset_rcnn_tpu_torch.utils import tracing

@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    yield
    tracing.disable()


def small_cfg(out=""):
    """The R50-FPN at a 96x160 bucket with few proposals (``test_e2e``'s
    settings), on the port's defaults."""
    cfg = get_default_cfg()
    cfg.SEED = 0
    cfg.OUTPUT_DIR = out
    cfg.OPENDET_BENCHMARK = True
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 4
    cfg.MODEL.ROI_HEADS.NUM_KNOWN_CLASSES = 3
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 100
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0
    cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[1.0]]
    cfg.MODEL.PIXEL_STD = [57.375, 57.12, 58.395]
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.BASE_LR = 0.002
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.STEPS = (10000,)
    cfg.SOLVER.CHECKPOINT_PERIOD = 1000
    cfg.INPUT.MIN_SIZE_TRAIN = (96,)
    cfg.INPUT.MAX_SIZE_TRAIN = 160
    cfg.INPUT.MIN_SIZE_TEST = 96
    cfg.INPUT.MAX_SIZE_TEST = 160
    cfg.TPU.TRAIN_BUCKET = (96, 160)
    cfg.TPU.TEST_BUCKET = (96, 160)
    cfg.TPU.MAX_GT_PER_IMAGE = 8
    cfg.TPU.EVAL_BATCH_SIZE = 2
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.TEST.EVAL_PERIOD = 0
    return cfg


class InMemory(DetectionTransform):
    """Pixels drawn from the record's id, no file."""

    def read_image(self, record):
        return np.full((record["height"], record["width"], 3), record["image_id"] % 251, np.uint8)


def records(n, hw=(120, 200)):
    return [{"image_id": 100 + i, "height": hw[0], "width": hw[1],
             "annotations": [{"bbox": [10.0, 20.0, 60.0, 90.0], "category_id": i % 3}]} for i in range(n)]


def transform(cfg, train=False):
    sizes = cfg.INPUT.MIN_SIZE_TRAIN if train else (cfg.INPUT.MIN_SIZE_TEST,)
    return InMemory(sizes, cfg.INPUT.MAX_SIZE_TEST, tuple(cfg.TPU.TEST_BUCKET), cfg.TPU.MAX_GT_PER_IMAGE, train)


class Evaluator:
    def __init__(self):
        self.seen = []

    def reset(self):
        self.seen = []

    def process(self, image_id, boxes, scores, classes):
        self.seen.append((image_id, len(scores)))

    def evaluate(self):
        return {"images": len(self.seen)}


def by_name(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


def test_off_records_nothing_and_allocates_no_span():
    """Off: every ``span`` is the one shared no-op, counters and requests do
    nothing, ``snapshot`` is None; ``stage`` still calls ``mark``;
    ``clock`` still times."""
    assert tracing.snapshot() is None
    assert tracing.span("a") is tracing.span("b", image_id=3) is tracing.NO_SPAN
    with tracing.span("a") as s:
        tracing.count("x", 5)
        tracing.request(7)
    assert s is tracing.NO_SPAN and tracing.snapshot() is None
    marks = []
    tracing.stage("backbone", marks.append)
    tracing.stage("rpn", None)
    assert marks == ["backbone"]
    with tracing.clock("eval.wait") as c:
        time.sleep(0.002)
    assert c.ms >= 2.0 and tracing.snapshot() is None
    tracing.enable()
    tracing.disable()
    assert tracing.span("a") is tracing.NO_SPAN and tracing.snapshot() is None


def test_nested_spans_parents_self_times_and_stages():
    """On: parents from the thread's open spans, self time = length less
    what the children cover, stage spans from the previous boundary (or the
    enclosing span's start) to the next, ``mark`` called at each."""
    tracing.enable()
    marks = []
    tracing.request("batch-1")
    with tracing.span("outer", tag=1):
        with tracing.span("inner"):
            time.sleep(0.002)
        with tracing.span("train.step"):
            time.sleep(0.001)
            tracing.stage("backbone", marks.append)
            time.sleep(0.001)
            tracing.stage("rpn", marks.append)
    tracing.stage("outside", marks.append)  # no open span: not recorded, mark still called
    snap = tracing.snapshot()
    (outer,), (inner,), (predict,) = by_name(snap, "outer"), by_name(snap, "inner"), by_name(snap, "train.step")
    (bb,), (rpn,) = by_name(snap, "stage.backbone"), by_name(snap, "stage.rpn")
    assert marks == ["backbone", "rpn", "outside"] and not by_name(snap, "stage.outside")
    assert outer["parent"] is None and inner["parent"] == predict["parent"] == outer["id"]
    assert bb["parent"] == rpn["parent"] == predict["id"]
    assert {s["request"] for s in snap["spans"]} == {"batch-1"} and outer["tag"] == 1
    assert bb["start_ns"] == predict["start_ns"] and rpn["start_ns"] == bb["end_ns"] <= rpn["end_ns"]
    length = lambda s: s["end_ns"] - s["start_ns"]
    assert inner["self_ns"] == length(inner) and bb["self_ns"] == length(bb)
    assert outer["self_ns"] == length(outer) - length(inner) - length(predict)
    assert predict["self_ns"] == predict["end_ns"] - rpn["end_ns"]
    assert {s["thread"] for s in snap["spans"]} == {threading.get_native_id()}
    assert abs(tracing.unix_ns(snap, time.perf_counter_ns()) - time.time_ns()) < 1e6


def test_counters_sum_across_threads():
    """Counters from more threads than cores, with a short switch interval,
    lose no update."""
    tracing.enable()
    n_threads, per_thread = 2 * (os.cpu_count() or 1) + 2, 2000
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread):
                tracing.count("hits")
                tracing.count("pairs", 2)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(before)
    counters = tracing.snapshot()["counters"]
    assert counters == {"hits": n_threads * per_thread, "pairs": 2 * n_threads * per_thread}


def test_train_loader_spans_carry_worker_threads_and_image_ids():
    """A ``TrainLoader`` with 2 workers: every image's ``data.read`` and
    ``data.transform`` on a worker thread with its image id, ``data.images``
    counts them, ``data.collate`` per batch on the consumer's thread; in
    ``device_prefetch`` ``data.h2d`` on its thread with the batch index and
    ``data.wait`` on the consumer's with the batch index as its request."""
    from openset_rcnn_tpu_torch.data import device_prefetch

    cfg = small_cfg()
    recs = records(6)
    loader = TrainLoader(recs, transform(cfg, train=True), batch_size=2, seed=0, num_workers=2, prefetch=1)
    tracing.enable()
    batches = []
    for batch, meta in device_prefetch(iter(loader), "cpu"):
        batches.append(meta.image_ids)
        if len(batches) == 3:
            names = {t.native_id: t.name for t in threading.enumerate()}
            break
    snap = tracing.snapshot()
    tracing.disable()
    main = threading.get_native_id()
    for name in ("data.read", "data.transform"):
        spans = by_name(snap, name)
        assert {names[s["thread"]] for s in spans} <= {"TrainLoader-0", "TrainLoader-1"}
        assert {s["request"] for s in spans} >= {i for ids in batches for i in ids}
    seen = [s["request"] for s in by_name(snap, "data.transform")]
    assert snap["counters"]["data.images"] == len(seen) >= 6
    collates = by_name(snap, "data.collate")
    assert len(collates) >= 3 and {names[s["thread"]] for s in collates} == {"device_prefetch"}
    h2d = by_name(snap, "data.h2d")
    assert [s["batch"] for s in h2d][:3] == [0, 1, 2] and {names[s["thread"]] for s in h2d} == {"device_prefetch"}
    waits = by_name(snap, "data.wait")
    assert {s["thread"] for s in waits} == {main} and [s["request"] for s in waits][:3] == [0, 1, 2]


@pytest.fixture(scope="module")
def predictor():
    return Predictor(small_cfg(), device="cpu")


def test_eval_loop_timings_are_its_spans(predictor):
    """``inference_on_dataset`` on the CPU: ``timings`` are the lengths of
    its ``eval.wait`` and ``eval.consume`` spans; each batch's spans carry
    its index and its image ids, each pass one ``eval.evaluate``; each
    batch one ``predict``; the loader's spans on ``device_prefetch``'s
    thread."""
    cfg = small_cfg()
    recs = records(5)
    tracing.enable()
    timings, results = [], []
    for _ in range(2):
        t, ev = {}, Evaluator()
        results.append(inference_on_dataset(predictor, EvalLoader(recs, transform(cfg), batch_size=2), ev, timings=t))
        timings.append(t)
    snap = tracing.snapshot()
    assert results == [{"images": 5}] * 2
    assert len(by_name(snap, "eval.evaluate")) == 2
    waits, consumes = by_name(snap, "eval.wait"), by_name(snap, "eval.consume")
    ms = lambda s: (s["end_ns"] - s["start_ns"]) / 1e6
    assert [ms(s) for s in waits] == timings[0]["wait_ms"] + timings[1]["wait_ms"]
    assert [ms(s) for s in consumes] == timings[0]["consume_ms"] + timings[1]["consume_ms"]
    assert [s["request"] for s in consumes] == [0, 1, 2] * 2 == [s["request"] for s in waits]
    assert [s["image_ids"] for s in consumes[:3]] == [[100, 101], [102, 103], [104]]
    assert snap["counters"] == {"data.images": 10, "data.resize.native": 10, "predict.eager": 6}  # on the CPU every call runs eagerly
    predicts = by_name(snap, "predict")
    assert [s["request"] for s in predicts] == [0, 1, 2] * 2
    assert {s["thread"] for s in predicts + waits + consumes} == {threading.get_native_id()}
    loader = by_name(snap, "data.transform")
    assert {s["request"] for s in loader} == {100, 101, 102, 103, 104}
    h2d_threads = {s["thread"] for s in by_name(snap, "data.h2d")}
    assert threading.get_native_id() not in h2d_threads and {s["thread"] for s in loader} == h2d_threads


def test_eval_loop_timings_without_tracing(predictor):
    """Off, ``timings`` still has one wait and one consume per batch, and
    the frame path's pieces (transform, collate, predict, ``to_host``)
    record nothing."""
    cfg = small_cfg()
    t = {}
    inference_on_dataset(predictor, EvalLoader(records(3), transform(cfg), batch_size=2), Evaluator(), timings=t)
    assert len(t["wait_ms"]) == len(t["consume_ms"]) == 2 and min(t["wait_ms"] + t["consume_ms"]) >= 0
    batch, meta = collate([transform(cfg)(r, np.random.RandomState(0)) for r in records(1)])
    to_host(predictor(batch.images, batch.image_hw), SERVE_FIELDS).numpy()
    assert tracing.snapshot() is None


def test_frame_spans_carry_the_frame_id(predictor):
    """A frame served on one thread as the benchmark's frame loop serves it
    (transform, ``collate``, ``Predictor``, ``to_host``): every span carries
    the frame's image id, set by the transform."""
    cfg = small_cfg()
    tf = transform(cfg)
    tracing.enable()
    for rec in records(2):
        batch, meta = collate([tf(rec, np.random.RandomState(0))])
        to_host(predictor(batch.images, batch.image_hw), SERVE_FIELDS).numpy()
    snap = tracing.snapshot()
    names = [s["name"] for s in snap["spans"] if s["request"] == 101]
    assert sorted(set(names)) == ["data.collate", "data.read", "data.transform", "eval.wait", "predict"]
    assert {s["request"] for s in snap["spans"]} == {100, 101}


def test_spans_land_on_the_profilers_clock(tmp_path):
    """Under ``torch.profiler`` (CPU activity), the ``aten::mm`` of a span
    lies inside it once the span is placed by the anchor, in the
    profiler's events and in its exported Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(384, 384)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.enable()
        with tracing.span("mm"):
            a @ a
        snap = tracing.snapshot()
        tracing.disable()
    (span,) = by_name(snap, "mm")
    lo, hi = tracing.unix_ns(snap, span["start_ns"]), tracing.unix_ns(snap, span["end_ns"])
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert lo <= mm.start_ns() <= mm.end_ns() <= hi
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    tracing.add_to_chrome_trace(path, snap)
    events = json.load(open(path))["traceEvents"]
    (mine,) = [e for e in events if e.get("cat") == "program"]
    (op,) = [e for e in events if e.get("name") == "aten::mm" and e.get("cat") == "cpu_op"]
    assert mine["name"] == "mm" and mine["tid"] == op["tid"]
    assert mine["ts"] <= op["ts"] and op["ts"] + op["dur"] <= mine["ts"] + mine["dur"] + 1e-3


def test_idle_by_span_files_each_gap_under_the_launching_threads_innermost_span():
    """Synthetic gaps against spans on two threads: a gap goes to the
    latest-starting span open across its middle on the thread that launched
    the work ending it, though a loader span on another thread started
    later; to the main thread's where the launcher has none open (the
    autograd engine's thread, an unknown one); "none" where neither has."""
    main, loader, autograd = 1, 2, 3
    spans = [  # (name, thread, start, end) in perf ns
        ("train.step", main, 100, 900), ("stage.backbone", main, 100, 400), ("stage.rpn", main, 400, 600),
        ("data.transform", loader, 450, 700), ("data.read", loader, 950, 1000), ("data.h2d", loader, 1100, 1200),
    ]
    snap = {"anchor": {"perf_ns": 0, "unix_ns": 10_000},
            "spans": [{"name": n, "thread": t, "start_ns": s, "end_ns": e} for n, t, s, e in spans]}
    gaps = [(10_200, 10_300, main),      # middle 250: backbone
            (10_500, 10_540, main),      # 520: rpn, not the loader's later data.transform
            (10_550, 10_570, autograd),  # 560: no spans of its own, so the main thread's rpn
            (10_640, 10_660, main),      # 650: train.step, rpn has ended; data.transform is the loader's
            (10_800, 10_820, loader),    # 810: the loader has none open, the main thread train.step
            (10_920, 10_940, main),      # 930: nothing open on the main thread
            (10_960, 11_000, main),      # 980: the loader's data.read is not the main thread's
            (11_120, 11_180, loader),    # 1150: a copy the loader's thread enqueued
            (11_300, 11_310, None)]      # launching thread unknown, nothing open on the main thread
    got = tracing.idle_by_span(gaps, snap, main=main)
    want = {"stage.backbone": 100e-9, "stage.rpn": 60e-9, "train.step": 40e-9, "none": 70e-9, "data.h2d": 60e-9}
    assert got.keys() == want.keys() and all(got[k] == pytest.approx(v) for k, v in want.items())
    assert list(got) == sorted(got, key=lambda k: -got[k])
    assert tracing.idle_by_span([], snap) == {}


class _Event:
    """A ``torch.profiler`` event as ``device_gaps`` reads it."""

    def __init__(self, name, start, end, corr, tid=0, device=False, annotation=False):
        self.args = name, start, end, corr, tid, device, annotation

    def name(self):
        return self.args[0]

    def start_ns(self):
        return self.args[1]

    def end_ns(self):
        return self.args[2]

    def correlation_id(self):
        return self.args[3]

    def device_resource_id(self):
        return self.args[4]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.args[5] else DeviceType.CPU

    def is_user_annotation(self):
        return self.args[6]


def test_device_gaps_name_the_launching_thread():
    """``device_gaps``: the holes in the union of the device's kernels,
    copies and memsets (not host ops, not annotations drawn on the device),
    each with the thread of the runtime or driver call whose correlation id
    the closing operation carries, as a native thread id."""
    me = threading.get_native_id()

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [
                        _Event("cudaLaunchKernel", 5, 8, 1, tid=11), _Event("gemm", 10, 20, 1, device=True),
                        _Event("cudaLaunchKernel", 12, 14, 2, tid=11), _Event("relu", 15, 30, 2, device=True),
                        _Event("cudaMemcpyAsync", 16, 17, 3, tid=12),
                        _Event("Memcpy HtoD (Pinned -> Device)", 40, 50, 3, device=True),
                        _Event("step", 0, 200, 4, device=True, annotation=True),
                        _Event("cuLaunchKernel", 52, 53, 5, tid=11), _Event("triton_", 60, 70, 5, device=True),
                        _Event("Memset (Device)", 90, 100, 7, device=True),  # its launch fell outside the profile
                        _Event("aten::mm", 0, 500, 3, tid=9),  # a host op whose id meets a device op's
                        # a thread whose host ops the profiler did not trace: its pthread id's low 32 bits
                        _Event("cudaLaunchKernel", 96, 97, 8, tid=threading.get_ident() & 0xFFFFFFFF),
                        _Event("gemm", 110, 120, 8, device=True),
                    ]

    assert tracing.device_gaps(Prof) == [(30, 40, 12), (50, 60, 11), (70, 90, None), (100, 110, me)]


def test_profile_steps_writes_program_spans_into_the_trace(tmp_path, caplog):
    """``do_train(profile_steps=2)`` on the CPU: the profiler's trace holds
    the program's spans of the profiled steps, loader threads and stages
    on their own thread rows, and the tracer is off again afterwards."""
    name = "tracing_synth_train"
    recs = generate_synthetic_dataset(str(tmp_path / "train"), num_images=6, image_hw=(120, 200), seed=0)
    DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: recs)
    MetadataCatalog.get(name).update(evaluator_type="voc_records", thing_classes=["c0", "c1", "c2", "unknown"])
    try:
        cfg = small_cfg(str(tmp_path / "out"))
        cfg.DATASETS.TRAIN, cfg.DATASETS.TEST = (name,), ()
        cfg.SOLVER.MAX_ITER = 7
        train_loop.do_train(cfg, profile_steps=2, device="cpu")
    finally:
        DatasetCatalog.remove(name)
    assert tracing.snapshot() is None
    events = json.load(open(tmp_path / "out" / "profile" / "trace.json"))["traceEvents"]
    program = [e for e in events if e.get("cat") == "program"]
    steps = [e for e in program if e["name"] == "train.step"]
    assert len(steps) == 2
    stages = {e["name"] for e in program if e["args"].get("parent") in {s["args"]["id"] for s in steps}}
    assert stages == {"stage.backbone", "stage.rpn", "stage.sampling", "stage.roi_align", "stage.heads",
                      "stage.backward", "stage.optimizer"}
    ops = {e["tid"] for e in events if e.get("cat") == "cpu_op"}
    assert {e["tid"] for e in steps} <= ops
    # the loader's workers run ahead of the steps, so the window need not hold a transform
    assert {e["name"] for e in program} >= {"data.collate", "data.h2d", "data.wait"}
    loader_tids = {e["tid"] for e in program if e["name"].startswith("data.") and e["name"] != "data.wait"}
    assert loader_tids and not loader_tids & {e["tid"] for e in steps}
    assert any(e.get("name") == "program counters" for e in events)


@pytest.mark.cuda
def test_launches_lie_inside_the_predict_span_on_the_card():
    """On the card: under ``torch.profiler`` (CPU and CUDA activity), every
    ``cudaLaunchKernel`` of a ``Predictor`` call lies inside its
    ``predict`` span once placed by the anchor, every idle gap names the
    calling thread as its launcher (with and without the host's activity
    traced), and ``idle_by_span`` files the gaps under ``predict``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    cfg = small_cfg()
    p = Predictor(cfg, device=dev)
    batch, meta = collate([transform(cfg)(r, np.random.RandomState(0)) for r in records(2)])
    to_host(p(batch.images, batch.image_hw), SERVE_FIELDS).numpy()  # builds the kernels, warms up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tracing.enable()
        out = to_host(p(batch.images, batch.image_hw), SERVE_FIELDS)
        snap = tracing.snapshot()
        tracing.disable()
        out.numpy()
        torch.cuda.synchronize()
    (span,) = by_name(snap, "predict")
    lo, hi = tracing.unix_ns(snap, span["start_ns"]), tracing.unix_ns(snap, span["end_ns"])
    launches = [e for e in prof.profiler.kineto_results.events() if e.name() == "cudaLaunchKernel"]
    assert launches
    outside = [(e.start_ns() - lo, e.end_ns() - hi) for e in launches if not lo <= e.start_ns() <= e.end_ns() <= hi]
    assert not outside, outside[:5]
    gaps = tracing.device_gaps(prof)
    assert gaps and {tid for _, _, tid in gaps} == {threading.get_native_id()}
    idle = tracing.idle_by_span(gaps, snap)
    assert set(idle) <= {"predict", "none"} and idle["predict"] > 0
    # the device's activity alone, as the benchmark profiles it: the calls carry pthread ids
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        to_host(p(batch.images, batch.image_hw), SERVE_FIELDS).numpy()
    gaps = tracing.device_gaps(prof)
    assert gaps and {tid for _, _, tid in gaps} == {threading.get_native_id()}
