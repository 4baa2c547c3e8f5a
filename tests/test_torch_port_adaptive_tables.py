"""The adaptive RoIAlign grid's per-bin axis tables, on the CPU.

K1's and K2 f32's adaptive modes compute a bin from per-axis tables of
distinct (cell, weight) pairs (``csrc/roi_align_adaptive.cuh``).
``openset_rcnn_tpu_torch.ops.roi_align`` holds a plain model of that
formulation (``adaptive_axis_tables``, ``roi_align_from_tables``,
``roi_align_bwd_from_tables``); these tests hold it to the bounds the
kernels rely on and to the references:

* on adversarial boxes (tiny, 1344 x 4 px on P2, across the edge, wholly
  below -1) a table has at most 2n pairs, at most n + 1 when its bin spans
  at most 8 cells, keeps every sample's weight, and a row or column meets at
  most 7 bins of a RoI;
* the table forward against ``roi_align_plain(..., -1)`` and JAX's
  ``_multilevel_roi_align_gather(..., sampling_ratio=-1)`` within atol 2e-5 +
  rtol 1e-5;
* the table backward against ``roi_align_bwd_plain(..., acc_dtype=float64)``
  within 1e-5 * max(1, max|want|), and against ``jax.vjp`` of the gather path;
* ``_native.library_path`` hashes the headers a kernel source includes.

The CUDA kernels themselves run only on the card (``tests/test_torch_port_cuda.py``,
``chip_smoke.py``).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_rcnn_tpu.ops import roi_align as jax_roi
from openset_rcnn_tpu_torch import _native
from openset_rcnn_tpu_torch.ops import roi_align as port_roi

STRIDES = (4, 8, 16, 32)
IMG_H, IMG_W = 128, 1344  # wide enough for a 1344 px box on P2
LEVEL_HW = [(-(-IMG_H // s), -(-IMG_W // s)) for s in STRIDES]
P = 7
ATOL, RTOL = 2e-5, 1e-5  # forward, elementwise
BWD_TOL = 1e-5           # backward, scaled by max(1, max|want|)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4  # against jax.vjp, as tests/test_torch_port_adaptive.py


def t(x):
    return torch.from_numpy(np.array(x))


def adversarial_boxes(rng, B, R):
    """Boxes whose adaptive counts take 1 (tiny boxes), 2-7 and the clip at
    8 (elongated boxes); 1344 x 4 px boxes on P2 (48 cells a bin, samples 6
    cells apart: 16 pairs a table); boxes across the image edge; boxes wholly
    below -1 (every sample out of range)."""
    n = R // 6
    side = np.exp(rng.uniform(np.log(8.0), np.log(400.0), (B, R)))
    ar = np.exp(rng.uniform(-1.0, 1.0, (B, R)))
    ar[:, :n] = rng.uniform(8.0, 20.0, (B, n))
    ar[:, n : 2 * n] = 1.0 / rng.uniform(8.0, 20.0, (B, n))
    w, h = side * np.sqrt(ar), side / np.sqrt(ar)
    cx, cy = rng.uniform(0, IMG_W, (B, R)), rng.uniform(0, IMG_H, (B, R))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    tiny = boxes[:, 2 * n : 3 * n]
    tiny[..., 2:] = tiny[..., :2] + rng.uniform(0.05, 1.5, tiny[..., 2:].shape)
    y0 = rng.uniform(0, IMG_H - 4, (B, 4))
    boxes[:, 3 * n : 3 * n + 4] = np.stack([np.zeros_like(y0), y0, np.full_like(y0, IMG_W), y0 + 4], -1)
    boxes[:, 3 * n + 4 : 3 * n + 8] = [[-60.0, -50.0, -10.0, -8.0], [-300.0, 10.0, -20.0, 50.0],
                                        [30.0, -90.0, 90.0, -12.0], [-80.0, -80.0, 2.0, 3.0]]
    return boxes.astype(np.float32)


@pytest.fixture
def boxes(rng):
    b = adversarial_boxes(rng, 2, 90)
    levels = port_roi.assign_levels(t(b)).numpy()
    n = b.shape[1] // 6
    assert (levels[:, 3 * n : 3 * n + 4] == 0).all()  # the 1344 x 4 px boxes pool from P2
    outside = (b[..., :2] < 0).any(-1) | (b[..., 2] > IMG_W) | (b[..., 3] > IMG_H)
    assert outside.any()
    return b


def axis_inputs(boxes):
    """Per RoI and axis (y, x): lo, hi in cells of the RoI's level, the
    level's extent, as the kernels compute them."""
    levels = port_roi.assign_levels(t(boxes)).reshape(-1).long()
    scale = 1.0 / torch.tensor(STRIDES, dtype=torch.float32)[levels]
    bx = t(boxes).reshape(-1, 4)
    hs = torch.tensor([h for h, _ in LEVEL_HW], dtype=torch.float32)[levels]
    ws = torch.tensor([w for _, w in LEVEL_HW], dtype=torch.float32)[levels]
    return ((bx[:, 1] * scale - 0.5, bx[:, 3] * scale - 0.5, hs),
            (bx[:, 0] * scale - 0.5, bx[:, 2] * scale - 0.5, ws))


def test_adaptive_table_width_bounds(boxes):
    widest = 0
    for lo, hi, extent in axis_inputs(boxes):
        cells, weights, pairs, n = port_roi.adaptive_axis_tables(lo, hi, extent, P)
        assert cells.shape[-1] <= 16
        assert (pairs <= 2 * n[:, None]).all()
        narrow = ((hi - lo) / P <= 8.0)[:, None].expand_as(pairs)
        assert (pairs[narrow] <= n[:, None].expand_as(pairs)[narrow] + 1).all()
        # cells ascending and distinct within a table, pads zero
        on = torch.arange(cells.shape[-1]) < pairs[..., None]
        assert ((cells[..., 1:] > cells[..., :-1]) | ~on[..., 1:]).all()
        assert (weights[~on] == 0).all() and (cells[~on] == 0).all()
        assert (weights[on] != 0).all()
        # every in-range sample's weight is in its bin's table: 1 a sample
        v0, v1, frac, ok, _, L = port_roi._sample_axis(lo, hi, extent, P, port_roi.ADAPTIVE)
        np.testing.assert_allclose(weights.sum(-1).numpy(), ok.reshape(-1, P, L).sum(-1).numpy(), rtol=1e-6)
        widest = max(widest, int(pairs.max()))
    assert widest == 16  # the long, thin boxes reach the bound
    level_widest, most_bins = port_roi.adaptive_table_widths(t(boxes), port_roi.assign_levels(t(boxes)), LEVEL_HW,
                                                             STRIDES, P)
    assert level_widest == 16
    assert most_bins == P  # a tiny box: all 7 bins through one cell
    # a box wholly below -1 keeps no pair at all
    (lo, hi, extent), _ = axis_inputs(np.array([[[-60.0, -50.0, -10.0, -8.0]]], np.float32))
    assert int(port_roi.adaptive_axis_tables(lo, hi, extent, P)[2].sum()) == 0


def jax_gather(feats, boxes):
    return jax.vmap(lambda fl, bb: jax_roi._multilevel_roi_align_gather(list(fl), bb, STRIDES, P, -1))(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(boxes))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_table_forward_matches_plain_and_gather(rng, boxes, dtype):
    C = 8
    feats = [rng.randn(2, h, w, C).astype(np.float32) for h, w in LEVEL_HW]
    if dtype == "bfloat16":  # the kernel's input dtype
        feats = [np.asarray(jnp.asarray(f, jnp.bfloat16).astype(jnp.float32)) for f in feats]
    pf = [t(f).to(torch.bfloat16) if dtype == "bfloat16" else t(f) for f in feats]
    levels = port_roi.assign_levels(t(boxes))
    got = port_roi.roi_align_from_tables(pf, t(boxes), levels, STRIDES, P, chunk=37)  # chunks that do not divide B * R
    assert got.dtype == torch.float32 and got.shape == (2, boxes.shape[1], P, P, C)
    plain = port_roi.roi_align_plain(pf, t(boxes), levels, STRIDES, P, -1)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_gather(feats, boxes)), atol=ATOL, rtol=RTOL)


def test_table_backward_matches_plain_f64_and_vjp(rng, boxes):
    B, R, C = 2, boxes.shape[1], 8
    g = rng.randn(B, R, P, P, C).astype(np.float32)
    levels = port_roi.assign_levels(t(boxes))
    got = port_roi.roi_align_bwd_from_tables(t(g), t(boxes), levels, LEVEL_HW, STRIDES, P, chunk=37)
    assert all(a.dtype == torch.float32 for a in got)
    want = port_roi.roi_align_bwd_plain(t(g), t(boxes), levels, LEVEL_HW, STRIDES, P, -1, acc_dtype=torch.float64)
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    assert max(float((a.double() - w).abs().max()) for a, w in zip(got, want)) <= BWD_TOL * scale
    zeros = tuple(jnp.zeros((B, h, w, C), jnp.float32) for h, w in LEVEL_HW)
    _, vjp = jax.vjp(lambda fs: jax_gather(fs, boxes), zeros)
    for a, w in zip(got, vjp(jnp.asarray(g))[0]):
        np.testing.assert_allclose(a.double().numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every library whose source includes it (a
    stale ``.so`` is never loaded); another library keeps its name."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_native.CSRC, csrc)
    monkeypatch.setattr(_native, "CSRC", csrc)
    for name in ("roi_align_fwd", "roi_align_bwd"):
        assert [p.name for p in _native.sources(name)] == [f"{name}.cu", "roi_align_adaptive.cuh"]
    assert [p.name for p in _native.sources("nms_keep")] == ["nms_keep.cu"]
    before = {name: _native.library_path(name) for name in _native.KERNELS}
    header = csrc / "roi_align_adaptive.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _native.library_path(name) for name in _native.KERNELS}
    assert {name for name in _native.KERNELS if after[name] != before[name]} == {"roi_align_fwd", "roi_align_bwd"}
    # a header included through another header counts too
    (csrc / "inner.cuh").write_text("// v1\n")
    header.write_text(header.read_text() + '#include "inner.cuh"\n')
    first = _native.library_path("roi_align_bwd")
    (csrc / "inner.cuh").write_text("// v2\n")
    assert _native.library_path("roi_align_bwd") != first
