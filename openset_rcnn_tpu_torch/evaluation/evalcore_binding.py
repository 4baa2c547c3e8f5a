"""ctypes binding for the native evaluation core (native/evalcore.cpp).

Copy of ``openset_rcnn_tpu/evaluation/evalcore_binding.py``, kept in the port so
that it imports nothing of the JAX package.

It builds the unchanged ``native/evalcore.cpp`` with ``g++`` (the flags of
``native/Makefile``) on first use into ``openset_rcnn_tpu_torch/_build/``,
under a name that carries a hash of the source and flags, and never writes
into ``native/``; callers fall back to numpy when it cannot be built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_CPP = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native", "evalcore.cpp"))
_BUILD_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "_build"))
_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")  # native/Makefile's

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Optional[str]:
    """Where the library of the current source and flags lives (None without the source)."""
    if not os.path.exists(_CPP):
        return None
    with open(_CPP, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_CXXFLAGS).encode()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libevalcore-{digest}.so")


def _build(so_path: str) -> bool:
    """Compile into a temporary name and rename, so that concurrent builders
    never load a half-written library."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *_CXXFLAGS, "-o", tmp, _CPP], check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so_path = library_path()
    if so_path is None or (not os.path.exists(so_path) and not _build(so_path)):
        return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None

    lib.greedy_match.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.greedy_match.restype = None
    lib.nms_sorted.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.nms_sorted.restype = ctypes.c_int64
    if hasattr(lib, "match_category"):
        P = ctypes.POINTER
        lib.match_category.argtypes = [
            P(ctypes.c_double),  # ious
            P(ctypes.c_double),  # d_area
            P(ctypes.c_double),  # g_area
            P(ctypes.c_int32),   # g_crowd
            P(ctypes.c_double),  # area_lo
            P(ctypes.c_double),  # area_hi
            ctypes.c_int64,      # A
            P(ctypes.c_double),  # iou_thrs
            ctypes.c_int64,      # T
            P(ctypes.c_int64),   # D
            P(ctypes.c_int64),   # G
            P(ctypes.c_int64),   # ioff
            P(ctypes.c_int64),   # goff
            P(ctypes.c_int64),   # doff
            ctypes.c_int64,      # n_img
            ctypes.c_int64,      # sum_d
            P(ctypes.c_uint8),   # out matched
            P(ctypes.c_uint8),   # out ignore
            P(ctypes.c_int32),   # out n_gt
        ]
        lib.match_category.restype = None
    _lib = lib
    return _lib


def match_category_native(
    ious_flat: np.ndarray,
    d_area: np.ndarray,
    g_area: np.ndarray,
    g_crowd: np.ndarray,
    D: np.ndarray,
    G: np.ndarray,
    area_ranges: np.ndarray,  # (A, 2)
    iou_thrs: np.ndarray,
):
    """One call for a whole category: every (image, area) matching.

    Returns (matched (A, T, sumD) bool, ignore (A, T, sumD) bool,
    n_gt (A, n_img) int32). Group i's detections occupy columns
    [doff[i], doff[i]+D[i]) where doff = cumsum-exclusive of D.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "match_category"):
        raise RuntimeError("evalcore match_category not available")
    P = ctypes.POINTER
    D = np.ascontiguousarray(D, np.int64)
    G = np.ascontiguousarray(G, np.int64)
    n_img = len(D)
    doff = np.zeros(n_img, np.int64)
    goff = np.zeros(n_img, np.int64)
    ioff = np.zeros(n_img, np.int64)
    np.cumsum(D[:-1], out=doff[1:])
    np.cumsum(G[:-1], out=goff[1:])
    np.cumsum((D * G)[:-1], out=ioff[1:])
    sum_d = int(D.sum())
    A = len(area_ranges)
    T = len(iou_thrs)
    ious_flat = np.ascontiguousarray(ious_flat, np.float64)
    d_area = np.ascontiguousarray(d_area, np.float64)
    g_area = np.ascontiguousarray(g_area, np.float64)
    g_crowd = np.ascontiguousarray(g_crowd, np.int32)
    lo = np.ascontiguousarray(area_ranges[:, 0], np.float64)
    hi = np.ascontiguousarray(area_ranges[:, 1], np.float64)
    iou_thrs = np.ascontiguousarray(iou_thrs, np.float64)
    matched = np.zeros((A, T, sum_d), np.uint8)
    ignore = np.zeros((A, T, sum_d), np.uint8)
    n_gt = np.zeros((A, n_img), np.int32)
    lib.match_category(
        ious_flat.ctypes.data_as(P(ctypes.c_double)),
        d_area.ctypes.data_as(P(ctypes.c_double)),
        g_area.ctypes.data_as(P(ctypes.c_double)),
        g_crowd.ctypes.data_as(P(ctypes.c_int32)),
        lo.ctypes.data_as(P(ctypes.c_double)),
        hi.ctypes.data_as(P(ctypes.c_double)),
        A,
        iou_thrs.ctypes.data_as(P(ctypes.c_double)),
        T,
        D.ctypes.data_as(P(ctypes.c_int64)),
        G.ctypes.data_as(P(ctypes.c_int64)),
        ioff.ctypes.data_as(P(ctypes.c_int64)),
        goff.ctypes.data_as(P(ctypes.c_int64)),
        doff.ctypes.data_as(P(ctypes.c_int64)),
        n_img,
        sum_d,
        matched.ctypes.data_as(P(ctypes.c_uint8)),
        ignore.ctypes.data_as(P(ctypes.c_uint8)),
        n_gt.ctypes.data_as(P(ctypes.c_int32)),
    )
    return matched.astype(bool), ignore.astype(bool), n_gt


def available() -> bool:
    return _load() is not None


def greedy_match_native(
    ious: np.ndarray,
    gt_ignore: np.ndarray,
    iscrowd: np.ndarray,
    iou_thrs: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        raise RuntimeError("evalcore not available")
    D, G = ious.shape
    T = len(iou_thrs)
    ious = np.ascontiguousarray(ious, np.float64)
    gt_ignore = np.ascontiguousarray(gt_ignore, np.int32)
    iscrowd = np.ascontiguousarray(iscrowd, np.int32)
    iou_thrs = np.ascontiguousarray(iou_thrs, np.float64)
    matched = np.zeros((T, D), np.uint8)
    ignore = np.zeros((T, D), np.uint8)
    lib.greedy_match(
        ious.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        gt_ignore.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        iscrowd.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        iou_thrs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        D,
        G,
        T,
        matched.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ignore.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return matched.astype(bool), ignore.astype(bool)


def nms_native(boxes_sorted: np.ndarray, thresh: float) -> np.ndarray:
    """Keep mask over score-sorted xyxy boxes."""
    lib = _load()
    if lib is None:
        raise RuntimeError("evalcore not available")
    boxes = np.ascontiguousarray(boxes_sorted, np.float64)
    keep = np.zeros(len(boxes), np.uint8)
    lib.nms_sorted(
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(boxes),
        float(thresh),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return keep.astype(bool)
