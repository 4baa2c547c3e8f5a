"""ctypes binding for the native evaluation core (native/evalcore.cpp).

Copy of ``openset_rcnn_tpu/evaluation/evalcore_binding.py``, kept in the port so
that it imports nothing of the JAX package.

``_native.py`` builds the unchanged ``native/evalcore.cpp`` with the host
compiler (the flags of ``native/Makefile``) on first use into
``openset_rcnn_tpu_torch/_build/``, and never writes into ``native/``.
Without a compiler the wrappers raise ``CompilerMissing`` and callers fall
back to numpy; a compiler that fails raises with its output.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from .. import _native


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
    lib = _native.load("evalcore")
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
    """Whether the library loads: False without a compiler; a compiler that
    fails raises with its output."""
    try:
        _native.load("evalcore")
    except _native.CompilerMissing:
        return False
    return True


def greedy_match_native(
    ious: np.ndarray,
    gt_ignore: np.ndarray,
    iscrowd: np.ndarray,
    iou_thrs: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    lib = _native.load("evalcore")
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
    lib = _native.load("evalcore")
    boxes = np.ascontiguousarray(boxes_sorted, np.float64)
    keep = np.zeros(len(boxes), np.uint8)
    lib.nms_sorted(
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(boxes),
        float(thresh),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return keep.astype(bool)
