"""The single-frame window: one client in a closed loop at batch 1. Each
frame goes from its decoded pixels through the test transform, ``collate``,
``Predictor``, the copy to the host (``to_host``) and
``finalize_serve_image``; the next frame starts when its detections are on
the host.

Set-up warms up the one bucket the frames use. The window serves the
traffic's frames in turn for ``--seconds``: ``frame_p95_ms`` is the 95th
percentile of every frame's latency, from holding the decoded frame to
having its detections on the host. Once it has closed and the predictor is
freed, ``sample`` frames drawn from the seed go through the reference and
each frame's detections are compared with those the program gave it last.

Traced: host spans around the transform, ``collate`` and the finalize, the
stage marks on CUDA events, and a profiler stretch of ``PROFILED_FRAMES``
frames.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from perfbench.harness import prepare
from perfbench.harness.core import Run, peak_memory, program_cfg, release, sync
from perfbench.harness.trace import Marks, Profile, Spans
from perfbench.entries.eval_loop import detection_checks

WARM_FRAMES = 8
PROFILE_AFTER = 20
PROFILED_FRAMES = 40


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
    transform.read_image = data.read_image
    s = {"cfg": cfg, "data": data, "weights": weights, "predictor": predictor, "transform": transform, "last": {}}
    for i in range(WARM_FRAMES):
        serve(s, data.records[i % len(data.records)])
    return s


def serve(s: dict, record: dict, spans: Spans = None, marks: Marks = None):
    """One frame, end to end; its detections on the host."""
    from openset_rcnn_tpu_torch.data import collate
    from openset_rcnn_tpu_torch.evaluation.postprocess import finalize_serve_image
    from openset_rcnn_tpu_torch.evaluation.testing import SERVE_FIELDS, to_host

    span = spans.span if spans is not None else (lambda name: contextlib.nullcontext())
    with span("transform"):
        ex = s["transform"](record, np.random.RandomState(0))
    with span("collate"):
        batch, meta = collate([ex])
    if marks is not None:
        marks.begin()
    out = to_host(s["predictor"](batch.images, batch.image_hw, mark=marks), SERVE_FIELDS).numpy()
    with span("finalize"):
        dets = finalize_serve_image(out["boxes"][0], out["scores"][0], out["classes"][0], out["valid"][0],
                                    meta.input_hw[0], meta.original_hw[0], s["predictor"].post_cfg)
    return dets


def window(r: Run, s: dict) -> None:
    records = s["data"].records
    marks, spans, profile = (Marks(), Spans(), Profile()) if r.trace else (None, None, None)
    latencies = []
    t0 = time.perf_counter()
    while True:
        i = len(latencies)
        if profile is not None and i == PROFILE_AFTER:
            profile.start()
        rec = records[i % len(records)]
        t = time.perf_counter()
        dets = serve(s, rec, spans, marks)
        latencies.append((time.perf_counter() - t) * 1e3)
        s["last"][rec["image_id"]] = (dets.boxes, dets.scores, dets.classes)
        if profile is not None and profile.active and i + 1 == PROFILE_AFTER + PROFILED_FRAMES:
            profile.stop()
        if time.perf_counter() - t0 >= r.seconds and (profile is None or not profile.active):
            break
    sync()
    r.e2e["frame_p95_ms"] = float(np.percentile(latencies, 95))
    r.attempted, r.failed = len(latencies), 0
    r.memory_peak_bytes = peak_memory(r.device)
    r.notes["frames"] = {"count": len(latencies), "median_ms": float(np.median(latencies)),
                         "p95_ms": r.e2e["frame_p95_ms"]}
    if r.trace:
        r.profile = profile.summary()
        r.per_layer_inputs.update(marks=marks, spans=spans, window_s=time.perf_counter() - t0,
                                  images=len(latencies), batch=1)


def numbers(r: Run, s: dict, control: str = None) -> dict:
    """The numbers of ``sample`` served frames drawn from the seed, each
    with the detections the program gave it last."""
    ids = sorted(s["last"])
    by_id = {rec["image_id"]: rec for rec in s["data"].records}
    records = [by_id[i] for i in prepare.sample(r, ids, int(r.cell["sample"]), "sample")]
    return detection_checks(r, s, s["last"], records, control)


def free(s: dict) -> None:
    s.pop("predictor", None)
    release()
