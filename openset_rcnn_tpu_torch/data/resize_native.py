"""The native bilinear resize, ``csrc/resize_bilinear.cpp``: the bytes of
``PIL.Image.resize(..., Image.BILINEAR)`` for uint8 3-channel images, in
one thread, written straight into a zeroed pad.

``_native.py`` builds it with the host compiler on first use. Without a
compiler, ``library()`` is None and callers keep PIL; a compiler that fails
raises with its output.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .. import _native


def library() -> Optional[ctypes.CDLL]:
    """The library, built on the first call (one thread builds, the loader's
    others wait); None where no host compiler is found."""
    try:
        return _native.load("resize_bilinear")
    except _native.CompilerMissing:
        return None


def resize(img: np.ndarray, nh: int, nw: int, pad_hw: Optional[Tuple[int, int]] = None,
           mirror: bool = False) -> Optional[np.ndarray]:
    """``img`` (H, W, 3) uint8 resized to (nh, nw) as PIL's BILINEAR does,
    mirrored left to right when asked, at the top left of a (*pad_hw, 3)
    array whose rest is zero (or alone without ``pad_hw``).

    A view with its channels reversed (``img[:, :, ::-1]``) or its rows
    apart is read in place. None where the library is not there or ``img``
    is not (H, W, 3) uint8.
    """
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        return None
    lib = library()
    if lib is None:
        return None
    h, w = img.shape[:2]
    ph, pw = pad_hw or (nh, nw)
    row, pixel, channel = img.strides
    if pixel != 3 or channel not in (1, -1) or row < 3 * w:
        img = np.ascontiguousarray(img)
        row, channel = img.strides[0], 1
    swap = channel == -1
    out = np.empty((ph, pw, 3), np.uint8)
    code = lib.resize_bilinear_u8c3(img.ctypes.data - (2 if swap else 0), h, w, row, int(swap),
                                    out.ctypes.data, nh, nw, ph, pw, out.strides[0], int(mirror))
    if code != 0:
        raise ValueError(f"resize_bilinear_u8c3: cannot resize {img.shape} to {(nh, nw)} in {(ph, pw)}")
    return out
