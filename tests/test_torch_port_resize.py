"""The native bilinear resize (``csrc/resize_bilinear.cpp`` through
``data/resize_native.py``) on the CPU: bitwise the installed Pillow's
``Image.resize(..., BILINEAR)`` over upscales, downscales and edge sizes, in
a pad, mirrored, from a channel-reversed or row-strided view;
``DetectionTransform``'s whole ``TransformedExample`` on the native path
bitwise the PIL path's over interp x flip x fmt x bucket. The builder
(``_native.py``) with it and the evaluation core: without a compiler PIL
runs and the evaluators answer on numpy in silence; a failing compiler's
output is in the resize's error and, once, in the evaluators' log, which
answer on numpy; threads that load one library at once run one compiler.
No JAX."""
import collections
import contextlib
import logging
import os
import shutil
import stat
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from openset_rcnn_tpu_torch import _native
from openset_rcnn_tpu_torch.data import resize_native
from openset_rcnn_tpu_torch.data.transforms import DetectionTransform, resize_image, resize_shortest_edge
from openset_rcnn_tpu_torch.evaluation import os_cocoeval
from openset_rcnn_tpu_torch.utils import tracing

EXAMPLE_FIELDS = ("image", "image_hw", "original_hw", "bucket_hw", "boxes", "classes", "gt_valid", "image_id")

# (in_h, in_w, out_h, out_w)
SIZES = {
    "frame_720p": (720, 1280, *resize_shortest_edge(720, 1280, 800, 1333)),
    "voc_up": (375, 500, *resize_shortest_edge(375, 500, 800, 1333)),
    "coco_up": (480, 640, *resize_shortest_edge(480, 640, 800, 1333)),
    "coco_up_427": (427, 640, *resize_shortest_edge(427, 640, 800, 1333)),
    "voc_portrait": (500, 333, *resize_shortest_edge(500, 333, 800, 1333)),
    "coco_portrait": (640, 427, *resize_shortest_edge(640, 427, 800, 1333)),
    "cap_1333": (400, 1000, *resize_shortest_edge(400, 1000, 800, 1333)),
    "down_ksize5": (1024, 1280, 800, 1000),
    "down_ksize7": (2000, 3000, *resize_shortest_edge(2000, 3000, 800, 1333)),
    "down_ksize9": (3100, 4000, 800, 1032),
    "down_train": (900, 700, 300, 233),
    "odd_up": (13, 17, 130, 170),
    "one_pixel": (1, 1, 5, 7),
    "two_pixels": (2, 2, 3, 9),
    "height_1": (1, 5, 1, 9),
    "width_1": (5, 1, 9, 1),
    "width_2": (2, 700, 3, 1333),
    "to_one": (100, 200, 1, 1),
    "same_height": (100, 1333, 100, 1000),
    "same_width": (720, 1280, 800, 1280),
}


def pil_resize(img, nh, nw):
    return np.asarray(Image.fromarray(np.ascontiguousarray(img)).resize((nw, nh), Image.BILINEAR))


@contextlib.contextmanager
def counters():
    """Run the block under a new tracer; the ``Counter`` it yields holds the
    tracer's counters once the block has run (0 for a name not counted).
    Tracing is off after it."""
    out = collections.Counter()
    tracing.enable()
    try:
        yield out
        out.update(tracing.snapshot()["counters"])
    finally:
        tracing.disable()


@pytest.mark.parametrize("name", sorted(SIZES))
def test_native_resize_is_pils(name):
    h, w, nh, nw = SIZES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    wide = rng.integers(0, 256, (h, w + 3, 3), dtype=np.uint8)
    img = np.ascontiguousarray(wide[:, :w])
    want = pil_resize(img, nh, nw)
    assert resize_native.library() is not None
    np.testing.assert_array_equal(resize_native.resize(img, nh, nw), want)
    # channels reversed in place, rows apart: what PIL gives for the copy
    np.testing.assert_array_equal(resize_native.resize(wide[:, :w, ::-1], nh, nw), pil_resize(img[:, :, ::-1], nh, nw))
    # mirrored into a pad whose rest is zero
    out = resize_native.resize(img, nh, nw, (nh + 3, nw + 5), mirror=True)
    np.testing.assert_array_equal(out[:nh, :nw], want[:, ::-1])
    assert not out[nh:].any() and not out[:, nw:].any()


def test_resize_image_counts_its_route():
    img = np.random.default_rng(0).integers(0, 256, (30, 40, 3), dtype=np.uint8)
    with counters() as n:
        np.testing.assert_array_equal(resize_image(img, 45, 60, "pil"), pil_resize(img, 45, 60))
        assert resize_image(img, 30, 40, "pil") is img  # no resize, nothing counted
        assert resize_image(img, 45, 60, "cv2").shape == (45, 60, 3)
    assert n == {"data.resize.native": 1}


class InMemory(DetectionTransform):
    def read_image(self, record):
        return record["pixels"]


def in_memory_records():
    """Landscape and portrait images, one that the smaller scale leaves at
    its size, each with boxes (one degenerate after the resize)."""
    rng = np.random.default_rng(5)
    records = []
    for i, (h, w) in enumerate([(200, 300), (300, 200), (96, 120), (130, 100), (150, 150)]):
        boxes = [[10.0, 12.0, w * 0.6, h * 0.7], [w * 0.5, 3.0, w - 1.0, h * 0.4], [7.0, 7.0, 7.0, 30.0]]
        records.append({"image_id": i, "file_name": None, "pixels": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                        "annotations": [{"bbox": b, "category_id": c} for c, b in enumerate(boxes)]})
    return records


def flipped(seed):
    """Whether ``DetectionTransform`` with two scales and flips flips under ``seed``."""
    rng = np.random.RandomState(seed)
    rng.randint(2)
    return rng.rand() < 0.5


def no_library(monkeypatch):
    monkeypatch.setattr(resize_native, "library", lambda: None)


@pytest.mark.parametrize("interp", ["pil", "cv2"])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("fmt", ["BGR", "RGB"])
@pytest.mark.parametrize("bucket_hw", [(160, 224), (224, 320)])
def test_detection_transform_native_is_the_pil_path(monkeypatch, interp, flip, fmt, bucket_hw):
    kw = dict(min_sizes=(96, 128), max_size=200, bucket_hw=bucket_hw, max_gt=4, flip=flip, fmt=fmt, interp=interp)
    records = in_memory_records()
    seeds = range(6)
    with counters() as on_native:
        got = [InMemory(**kw)(rec, np.random.RandomState(seed)) for rec in records for seed in seeds]
    with monkeypatch.context() as m, counters() as on_pil:
        no_library(m)
        want = [InMemory(**kw)(rec, np.random.RandomState(seed)) for rec in records for seed in seeds]
    native = on_native["data.resize.native"]
    pil = on_native["data.resize.pil"] + on_pil["data.resize.pil"]
    resized = sum(g.image_hw != g.original_hw for g in got)
    assert 0 < resized < len(got)  # resized and left at size both occur
    assert (native, pil) == ((resized, resized) if interp == "pil" else (0, 0))
    if flip:
        assert {flipped(seed) for seed in seeds} == {True, False}
    for g, w in zip(got, want, strict=True):
        for f in EXAMPLE_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
        assert g.image.dtype == np.uint8 and g.image.shape == (*g.bucket_hw, 3)
        h, w_ = g.image_hw
        assert not g.image[h:].any() and not g.image[:, w_:].any()


def fresh_library(monkeypatch, tmp_path, cxx):
    """Forget every library loaded or failed and build into an empty
    directory with ``cxx``."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_loaded", {})
    monkeypatch.setattr(_native, "_failed", {})
    monkeypatch.setenv("CXX", str(cxx))


def compiler(tmp_path, body):
    """A compiler script that appends a line to ``runs`` each time it runs,
    then runs ``body``."""
    cxx = tmp_path / "cxx"
    cxx.write_text(f"#!/bin/sh\necho run >> {tmp_path / 'runs'}\n{body}\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    return cxx


FAILING = "echo 'error: no luck' >&2\nexit 1"


def test_without_a_compiler_pil_runs(monkeypatch, tmp_path):
    fresh_library(monkeypatch, tmp_path, tmp_path / "no-such-compiler")
    assert resize_native.library() is None
    rec = in_memory_records()[0]
    with counters() as n:
        ex = InMemory((128,), 200, (160, 224), 4, flip=False)(rec, np.random.RandomState(0))
    assert (n["data.resize.native"], n["data.resize.pil"]) == (0, 1)
    np.testing.assert_array_equal(ex.image[:ex.image_hw[0], :ex.image_hw[1]], pil_resize(rec["pixels"], *ex.image_hw))


def matching_inputs():
    rng = np.random.default_rng(1)
    return rng.random((9, 4)), np.array([0, 0, 0, 1], np.int32), np.array([0, 1, 0, 0], np.int32), os_cocoeval.IOU_THRS


def test_without_a_compiler_the_evaluators_answer_in_silence(monkeypatch, tmp_path, caplog):
    """No compiler: the evaluators' matcher answers on numpy what the library
    answers, and nothing is logged."""
    want = os_cocoeval.greedy_match(*matching_inputs())
    fresh_library(monkeypatch, tmp_path, tmp_path / "no-such-compiler")
    monkeypatch.setattr(os_cocoeval, "_GREEDY_NATIVE_WARNED", False)
    with caplog.at_level(logging.WARNING, logger=os_cocoeval.__name__):
        got = os_cocoeval.greedy_match(*matching_inputs())
    assert not caplog.records
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("library", ["resize_bilinear", "evalcore"])
def test_a_failing_compiler_raises_with_its_output(monkeypatch, tmp_path, caplog, library):
    """The resize raises the compiler's output; the evaluators log it once
    and answer on numpy what the library answers."""
    want = os_cocoeval.greedy_match(*matching_inputs())
    fresh_library(monkeypatch, tmp_path, compiler(tmp_path, FAILING))
    if library == "resize_bilinear":
        with pytest.raises(RuntimeError, match="no luck"):
            resize_native.library()
    else:
        monkeypatch.setattr(os_cocoeval, "_GREEDY_NATIVE_WARNED", False)
        with caplog.at_level(logging.WARNING, logger=os_cocoeval.__name__):
            got = [os_cocoeval.greedy_match(*matching_inputs()) for _ in range(2)]
        assert len([r for r in caplog.records if "no luck" in r.getMessage()]) == 1
        for answer in got:
            for a, b in zip(answer, want, strict=True):
                np.testing.assert_array_equal(a, b)
    assert not os.listdir(tmp_path / "build")  # nothing half-written is left to load


@pytest.mark.parametrize("outcome", ["built", "failed"])
def test_threads_loading_one_library_run_one_compiler(monkeypatch, tmp_path, outcome):
    """Eight threads load one unbuilt library at once: the compiler runs
    once and every thread gets its outcome, the library or its error; a
    later load does not run it again."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "the host resize needs a host compiler"
    body = f'sleep 0.2\nexec {cxx} "$@"' if outcome == "built" else f"sleep 0.2\n{FAILING}"
    fresh_library(monkeypatch, tmp_path, compiler(tmp_path, body))
    barrier = threading.Barrier(8)

    def load(wait=True):
        if wait:
            barrier.wait(timeout=60)
        try:
            return _native.load("resize_bilinear")
        except _native.BuildFailed as e:
            return e

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            got = [f.result(timeout=120) for f in [pool.submit(load) for _ in range(8)]]
    finally:
        sys.setswitchinterval(interval)
    got.append(load(wait=False))
    assert (tmp_path / "runs").read_text().splitlines() == ["run"]
    if outcome == "built":
        assert all(lib is got[0] for lib in got)
        img = np.random.default_rng(2).integers(0, 256, (30, 40, 3), dtype=np.uint8)
        np.testing.assert_array_equal(resize_native.resize(img, 45, 60), pil_resize(img, 45, 60))
    else:
        assert all(isinstance(e, _native.BuildFailed) and "no luck" in str(e) for e in got)
        assert not os.listdir(tmp_path / "build")
