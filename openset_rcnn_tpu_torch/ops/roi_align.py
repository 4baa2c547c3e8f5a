"""Multilevel RoIAlign (V2 / aligned=True): level assignment, plain versions,
kernel wrappers.

Port of ``openset_rcnn_tpu/ops/roi_align.py:37-193, 340-437`` and of the two
TPU kernels' level rule (``ops/pallas/roi_align_kernel.py:59-64``). Every
RoI is pooled with exact bilinear RoIAlign from the FPN level it is given.

* Levels are computed once, in torch, and handed to the kernel and to the
  plain version alike, so ``log2`` rounding cannot move a box across a level
  boundary between them. ``assign_levels`` is the gather path's rule;
  ``assign_levels_window_fit`` is the TPU kernels' window-fit rule, which
  moves a box whose longer side spans more than ``MAX_EXTENT`` cells of its
  level up to the first level where it fits (boxes of aspect ratio above
  ~3.6).
* ``roi_align_plain`` is the gather formulation in PyTorch, chunked over RoIs
  (as ``_gather_chunked`` is) so its (chunk, 14, 14, C) neighbour tensors stay
  small at ~4.3k RoIs per image. The CPU path and the kernels' oracle.
* ``roi_align`` is the wrapper of K1 (``roi_align_pallas_v2``): bf16 features
  in, f32 out; the plain version for CPU tensors, the CUDA kernel
  (``csrc/roi_align_fwd.cu``) for CUDA tensors. There is no fallback. It
  goes through the PyTorch operator ``openset_rcnn::roi_align_fwd``
  (``roi_align_op``: CPU and CUDA implementations and a fake one for
  tracing), so ``torch.export`` records K1 as one node and a loaded
  exported program launches the kernel as eager code does.
* ``roi_align_window`` is the counterpart of K5 (``roi_align_pallas_fwd``):
  window-fit levels, f32 or bf16 features, the output in the features' dtype
  (computed in f32, rounded once); the same CUDA source.
* The backward (port of the custom VJP at ``ops/roi_align.py:402-437``):
  ``roi_align_bwd_plain`` transposes the gather path. With f32 accumulators
  it is one explicit f32 ``index_add_``; with bf16 accumulators (the
  ``pallas_bf16`` mode of K2) it visits the RoIs as the TPU kernel does, one
  RoI of every image per round, and adds each RoI's f32 window gradient to
  the bf16 accumulators in one read-add-round. ``roi_align_bwd`` and
  ``roi_align_bwd_bf16`` are the wrappers, with the CUDA kernels of
  ``csrc/roi_align_bwd.cu`` for CUDA tensors (one tile-owner template for
  both accumulator types: deterministic, every cell written once). ``RoIAlignFunction`` joins
  forward and backward into one differentiable op; its backward rounds the
  accumulators to the features' dtype, as the JAX VJP does, and gives the
  boxes no gradient.

* The adaptive grid (``sampling_ratio == -1``, ``TPU.ROI_SAMPLING_RATIO
  -1``, both ``*_parity.yaml`` configs) is the gather path's
  (``openset_rcnn_tpu/ops/roi_align.py:93-94, 124-135, 188-193``): per RoI
  and axis ``n = clip(ceil(extent / P), 1, 8)`` samples a bin at
  ``p + (j + 0.5) / n`` bin units, on a masked 8-lattice; a bin's value is
  the sum of its samples over ``n_y * n_x`` (clipped samples add 0 and stay
  in the count). The plain versions cut each chunk's lattice to its largest
  count: the lattice points beyond it are masked for every RoI of the
  chunk, and each sum still adds the active samples in their order. K1 and
  K2's f32 mode take it; K2's bf16 mode and K5 do not. Their kernels
  compute it from per-bin axis tables (``csrc/roi_align_adaptive.cuh``):
  per RoI, axis and bin the distinct (cell, weight) pairs, at most 16, so a
  bin's value is ``sum wy(r) wx(c) f[r, c] / (n_y n_x)``. That reassociates
  the sums, so the kernels are held to the plain versions by tolerance, not
  bitwise. ``adaptive_axis_tables`` and ``roi_align_from_tables`` /
  ``roi_align_bwd_from_tables`` are a plain model of that formulation for
  the tests and chip_smoke's table widths; no entry point calls them.

Layout: features are per-level NHWC (B, H_l, W_l, C); boxes (B, R, 4) xyxy
f32 in image coordinates; the output is (B, R, P, P, C), the JAX package's
layout, so a flatten of the last three dims matches its ``fc1``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import _native
from ..utils import tracing

# RoIs per step of the plain version: 512 RoIs at the static 2x2 grid, the
# budget of the JAX package's GATHER_CHUNK_BUDGET.
PLAIN_CHUNK = 512
NUM_LEVELS = 4
# sampling_ratio of the adaptive grid, and the side of its lattice per bin
# (ADAPTIVE_MAX_RATIO of the JAX gather path)
ADAPTIVE = -1
ADAPTIVE_MAX_RATIO = 8
# The TPU kernels' window-fit bound: a RoI's longer side spans at most this
# many cells of its level (roi_align_kernel.py:33, with a 56x64 window).
MAX_EXTENT = 50.0


def assign_levels(
    boxes: torch.Tensor,
    min_level: int = 2,
    max_level: int = 5,
    canonical_size: float = 224.0,
    canonical_level: int = 4,
) -> torch.Tensor:
    """(...,) int32 FPN level index (0-based: level - min_level)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    size = torch.sqrt(torch.clamp(w * h, min=0.0))
    lvl = torch.floor(canonical_level + torch.log2(size / canonical_size + 1e-8))
    lvl = torch.clamp(lvl, min_level, max_level)
    return (lvl - min_level).to(torch.int32)


def assign_levels_window_fit(boxes: torch.Tensor, strides: Sequence[int]) -> torch.Tensor:
    """(...,) int32 level index under the TPU kernels' window-fit rule
    (``roi_align_kernel.py::_geometry``, lines 59-64): the canonical level,
    raised to the first level whose cells the box's longer side spans at
    most ``MAX_EXTENT`` times, clipped to the pyramid."""
    n = len(strides)
    lvl = assign_levels(boxes, min_level=2, max_level=2 + n - 1)
    max_side = torch.clamp(torch.maximum(boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]), min=1e-6)
    # a tensor divisor: on CUDA a Python-scalar divisor becomes a multiply by
    # its reciprocal, one rounding off the quotient the JAX rule computes
    need = torch.ceil(torch.log2(max_side / torch.full_like(max_side, strides[0] * MAX_EXTENT)))
    return torch.clamp(torch.maximum(lvl, need.to(torch.int32)), 0, n - 1).to(torch.int32)


def _sample_axis(lo, hi, extent, P: int, S: int):
    """Sample geometry along one axis for a chunk of RoIs, as the gather path
    computes it. lo/hi/extent: (n,) f32; S the sampling ratio (``ADAPTIVE``:
    the adaptive grid). Returns (n, P*L) tensors on the lattice of L
    samples a bin (the static ratio, or the chunk's largest adaptive count):
    floor neighbour, upper neighbour (int64), fraction, in-range (and,
    adaptive, active) mask (f32); the (n,) f32 count of samples a bin takes
    on this axis; and L."""
    # Divisions take a tensor divisor: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, one rounding off the true quotient
    # that the kernel and the JAX gather path compute.
    bin_size = (hi - lo) / torch.full_like(lo, P)
    if S == ADAPTIVE:
        n = torch.clamp(torch.ceil(bin_size), 1.0, float(ADAPTIVE_MAX_RATIO))
        L = int(n.nan_to_num(float(ADAPTIVE_MAX_RATIO)).max())  # a NaN box keeps the whole lattice, masked
    else:
        L = S
    idx = torch.arange(P * L, device=lo.device)
    j = (idx % L).to(torch.float32)
    if S == ADAPTIVE:
        in_bins = (idx // L).to(torch.float32) + (j + 0.5) / n[:, None]
    else:
        n = torch.full_like(lo, S)
        in_bins = ((idx // L).to(torch.float32) + (j + 0.5) / n[:1])[None, :]
    v = lo[:, None] + in_bins * bin_size[:, None]
    ext = extent[:, None]
    ok = (v > -1.0) & (v < ext)
    if S == ADAPTIVE:
        ok = ok & (j[None, :] < n[:, None])
    ok = ok.to(torch.float32)
    v = torch.minimum(torch.clamp(v, min=0.0), ext - 1.0)
    v0 = torch.floor(v)
    v1 = torch.minimum(v0 + 1, ext - 1.0)
    return v0.to(torch.int64), v1.to(torch.int64), v - v0, ok, n, L


def roi_align_plain(
    feats: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
    chunk: int = PLAIN_CHUNK,
) -> torch.Tensor:
    """Plain PyTorch RoIAlignV2 on any device, in f32 whatever the features'
    dtype; see the module docstring."""
    B, R = boxes.shape[:2]
    C = feats[0].shape[-1]
    P, S = out_size, sampling_ratio
    # one flat (B * sum_l H_l W_l, C) buffer: image-major, then level, then row
    flat = torch.cat([f.reshape(B, -1, C) for f in feats], dim=1).reshape(-1, C)
    out = torch.empty((B * R, P, P, C), dtype=torch.float32, device=boxes.device)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    for sl, n, neighbours, ok, count, (Ly, Lx) in _chunk_geometry(boxes, levels, level_hw, strides, P, S,
                                                                  _chunk(chunk, S)):
        val = sum(flat[idx.reshape(-1)].reshape(n, P * Ly, P * Lx, C).float() * w[..., None]
                  for idx, w in neighbours)
        val = (val * ok[..., None]).reshape(n, P, Ly, P, Lx, C)
        if S != ADAPTIVE:
            out[sl] = val.mean(dim=(2, 4))
            continue
        # the kernel's order: sample after sample, row-major; inactive
        # samples add 0
        acc = torch.zeros((n, P, P, C), dtype=torch.float32, device=boxes.device)
        for sy in range(Ly):
            for sx in range(Lx):
                acc = acc + val[:, :, sy, :, sx]
        out[sl] = acc / count[:, None, None, None]
    return out.reshape(B, R, P, P, C)


def _chunk(chunk: int, S: int) -> int:
    """RoIs per step: the adaptive lattice has 16x the samples of the static
    2x2 grid, so 16x fewer RoIs (at least 32, as ``_gather_chunked``)."""
    return max(32, chunk // 16) if S == ADAPTIVE else chunk


def roi_align_window_plain(
    feats: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Plain version of K5: window-fit levels, the gather path's arithmetic
    in f32, the result cast to the features' dtype."""
    levels = assign_levels_window_fit(boxes, strides)
    return roi_align_plain(feats, boxes, levels, strides, out_size, sampling_ratio).to(feats[0].dtype)


def _chunk_geometry(boxes, levels, level_hw, strides, P: int, S: int, chunk: int):
    """Per chunk of RoIs, the sample geometry of the gather path: (slice of
    the flattened RoIs, RoI count, the 4 bilinear neighbours as (flat row
    index (n, P Ly, P Lx), weight (n, P Ly, P Lx)), in-range mask
    (n, P Ly, P Lx), the (n,) f32 samples a bin averages, the lattice's
    (Ly, Lx) samples a bin axis).
    Flat rows index one (B * sum_l H_l W_l) buffer, image-major, then level."""
    for sl, bx, origin, scale, H, W in _roi_chunks(boxes, levels, level_hw, strides, chunk):
        y0, y1, ly, oky, ny, Ly = _sample_axis(bx[:, 1] * scale - 0.5, bx[:, 3] * scale - 0.5, H, P, S)
        x0, x1, lx, okx, nx, Lx = _sample_axis(bx[:, 0] * scale - 0.5, bx[:, 2] * scale - 0.5, W, P, S)
        base = origin[:, None, None]
        Wl = W.long()[:, None, None]

        def idx(yy, xx):
            return base + yy[:, :, None] * Wl + xx[:, None, :]

        neighbours = (
            (idx(y0, x0), (1 - ly)[:, :, None] * (1 - lx)[:, None, :]),
            (idx(y0, x1), (1 - ly)[:, :, None] * lx[:, None, :]),
            (idx(y1, x0), ly[:, :, None] * (1 - lx)[:, None, :]),
            (idx(y1, x1), ly[:, :, None] * lx[:, None, :]),
        )
        yield sl, bx.shape[0], neighbours, oky[:, :, None] * okx[:, None, :], ny * nx, (Ly, Lx)


def _roi_chunks(boxes, levels, level_hw, strides, chunk: int):
    """Per chunk of the flattened RoIs: (slice, boxes (n, 4), flat row of
    each RoI's map origin in one (B * sum_l H_l W_l) buffer, image-major,
    then level (n,), 1 / stride (n,), the map's H and W (n,) f32)."""
    B, R = boxes.shape[:2]
    dev = boxes.device
    sizes = [h * w for h, w in level_hw]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    hs = torch.tensor([h for h, _ in level_hw], dtype=torch.float32, device=dev)
    ws = torch.tensor([w for _, w in level_hw], dtype=torch.float32, device=dev)
    inv_strides = torch.tensor([1.0 / s for s in strides], dtype=torch.float32, device=dev)
    flat_boxes, flat_levels = boxes.reshape(-1, 4), levels.reshape(-1).long()
    image = torch.arange(B, device=dev).repeat_interleave(R)
    for start in range(0, B * R, chunk):
        sl = slice(start, min(start + chunk, B * R))
        lvl = flat_levels[sl]
        yield sl, flat_boxes[sl], image[sl] * sum(sizes) + offsets[lvl], inv_strides[lvl], hs[lvl], ws[lvl]


def _check_grid(P: int, S: int, adaptive: bool) -> None:
    """The kernels take a static grid with ``P * S <= 32``; K1 and K2's f32
    mode (``adaptive``) also the adaptive grid, on a lattice of ``P * 8 <=
    56`` samples a side."""
    if S == ADAPTIVE and adaptive:
        if P < 1 or P * ADAPTIVE_MAX_RATIO > 56:
            raise ValueError("the adaptive grid takes out_size * 8 <= 56")
    elif S < 1 or P * S > 32:
        raise ValueError("the kernel takes a static sampling ratio >= 1 and out_size * sampling_ratio <= 32"
                         + ("" if adaptive else ", not the adaptive grid"))


def _check_cuda_inputs(feats, boxes, levels, strides, P, S, dtypes=(torch.bfloat16,), adaptive=True):
    if len(feats) != NUM_LEVELS or len(strides) != NUM_LEVELS:
        raise ValueError(f"the kernel pools exactly {NUM_LEVELS} FPN levels, got {len(feats)}")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, R, 4) float32, got {tuple(boxes.shape)} {boxes.dtype}")
    B, R = boxes.shape[:2]
    if levels.dtype != torch.int32 or tuple(levels.shape) != (B, R):
        raise ValueError(f"levels must be ({B}, {R}) int32, got {tuple(levels.shape)} {levels.dtype}")
    C = feats[0].shape[-1]
    names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
    for f in feats:
        if f.dtype not in dtypes or f.dtype != feats[0].dtype or f.dim() != 4 or f.shape[0] != B or f.shape[-1] != C:
            raise ValueError(f"features must be (B, H, W, {C}) {names}, all of one dtype, "
                             f"got {tuple(f.shape)} {f.dtype}")
    for t in (*feats, boxes, levels):
        if t.device != boxes.device:
            raise ValueError("features, boxes and levels must be on one device")
        if not t.is_contiguous():
            raise ValueError("features (NHWC), boxes and levels must be contiguous")
    _check_grid(P, S, adaptive)


def _launch_fwd(fn: str, feats, boxes, levels, strides, P, S, out, *dtype_flag):
    B, R = boxes.shape[:2]
    lib = _native.load("roi_align_fwd")
    hw = [d for f in feats for d in (f.shape[1], f.shape[2])]
    with torch.cuda.device(boxes.device):
        code = getattr(lib, fn)(
            *[f.data_ptr() for f in feats], *hw, *[1.0 / s for s in strides],
            boxes.data_ptr(), levels.data_ptr(), B * R, R, feats[0].shape[-1], P, S, *dtype_flag,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _native.check(lib, fn, code)


# K1 as a PyTorch operator, ``torch.ops.openset_rcnn.roi_align_fwd``: the plain
# version for CPU tensors, the launch code for CUDA tensors, shapes only for
# meta and fake tensors (tracing). It is registered through torch.library's
# low-level API: ``torch.library.custom_op`` adds Python layers to every
# call (autograd wrapping, alias checks), which made K4's ~0.09 ms calls
# host-bound on the H100 (PERF.md §6).
OPS = torch.library.Library("openset_rcnn", "FRAGMENT")  # ops/nms.py defines the namespace's other operator
OPS.define("roi_align_fwd(Tensor[] feats, Tensor boxes, Tensor levels, int[] strides, int out_size, "
           "int sampling_ratio) -> Tensor")


def _roi_align_cuda(feats, boxes, levels, strides, out_size, sampling_ratio):
    """The CUDA implementation: launches the kernel or raises."""
    P, S = out_size, sampling_ratio
    _check_cuda_inputs(feats, boxes, levels, strides, P, S)
    B, R = boxes.shape[:2]
    out = torch.empty((B, R, P, P, feats[0].shape[-1]), dtype=torch.float32, device=boxes.device)
    if B * R == 0:
        return out
    _launch_fwd("roi_align_fwd", feats, boxes, levels, strides, P, S, out)
    tracing.count("kernel.roi_align_fwd.adaptive" if S == ADAPTIVE else "kernel.roi_align_fwd")
    return out


def _roi_align_fake(feats, boxes, levels, strides, out_size, sampling_ratio):
    """Shape and dtype only, for tracing (``torch.export``): no data, no
    launch, no count."""
    B, R = boxes.shape[:2]
    return boxes.new_empty((B, R, out_size, out_size, feats[0].shape[-1]), dtype=torch.float32)


OPS.impl("roi_align_fwd", roi_align_plain, "CPU")
OPS.impl("roi_align_fwd", _roi_align_cuda, "CUDA")
torch.library.register_fake("openset_rcnn::roi_align_fwd", _roi_align_fake, lib=OPS)
roi_align_op = torch.ops.openset_rcnn.roi_align_fwd.default


def roi_align(
    feats: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """RoIAlignV2 forward (K1): (B, R, P, P, C) f32 from NHWC bf16 P2-P5,
    each RoI from the level in ``levels``; ``sampling_ratio`` static, or
    ``ADAPTIVE``.

    It calls the custom operator ``openset_rcnn::roi_align_fwd``, so eager
    code and an exported program take one route: CPU tensors take the plain
    version; CUDA tensors launch the kernel, counted by the tracer as
    ``kernel.roi_align_fwd`` on the static grid and
    ``kernel.roi_align_fwd.adaptive`` on the adaptive one (the operator's
    CUDA implementation counts them, so a loaded exported program counts
    too). Tensors on another device are refused (the operator itself also
    takes meta and fake tensors, for tracing).
    """
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"roi_align runs on CPU or CUDA tensors, not {boxes.device}")
    return roi_align_op(list(feats), boxes, levels, [int(s) for s in strides], int(out_size), int(sampling_ratio))


def roi_align_window(
    feats: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """K5's API (``roi_align_pallas_fwd``): per-level (B, H_l, W_l, C) f32 or
    bf16 features, (B, R, 4) f32 boxes -> (B, R, P, P, C) in the features'
    dtype, each RoI at its window-fit level.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if boxes.device.type == "cpu":
        return roi_align_window_plain(feats, boxes, strides, out_size, sampling_ratio)
    if boxes.device.type != "cuda":
        raise ValueError(f"roi_align_window runs on CPU or CUDA tensors, not {boxes.device}")
    P, S = out_size, sampling_ratio
    levels = assign_levels_window_fit(boxes, strides)
    _check_cuda_inputs(feats, boxes, levels, strides, P, S, dtypes=(torch.float32, torch.bfloat16), adaptive=False)
    B, R = boxes.shape[:2]
    out = torch.empty((B, R, P, P, feats[0].shape[-1]), dtype=feats[0].dtype, device=boxes.device)
    if B * R == 0:
        return out
    _launch_fwd("roi_align_window_fwd", feats, boxes, levels, strides, P, S, out,
                int(feats[0].dtype == torch.bfloat16))
    tracing.count("kernel.roi_align_window")
    return out


# ------------------------------------------- the adaptive grid's axis tables


def adaptive_axis_tables(lo, hi, extent, P: int = 7):
    """The adaptive grid's per-bin tables of one axis, for a chunk of RoIs
    (the kernels' formulation, ``csrc/roi_align_adaptive.cuh::axis_table``).

    lo/hi/extent: (n,) f32 as ``_sample_axis`` takes them. Returns cells
    (n, P, 2L) int64 and weights (n, P, 2L) f32, each bin's distinct cells
    in ascending order with the summed ``ok * (1 - frac)`` / ``ok * frac``
    of its samples, padded with cell 0 and weight 0; pairs (n, P) int64,
    the pairs of each bin (pairs of weight 0 left out); and the (n,) f32
    samples a bin takes. L is the chunk's lattice (its largest count), so
    2L <= 16."""
    v0, v1, frac, ok, count, L = _sample_axis(lo, hi, extent, P, ADAPTIVE)
    n = lo.shape[0]
    cells = torch.stack([v0, v1], -1).reshape(n, P, 2 * L)  # sample order: lower neighbour, then upper
    w = torch.stack([(1 - frac) * ok, frac * ok], -1).reshape(n, P, 2 * L)
    keep = w != 0
    key = torch.where(keep, cells, torch.iinfo(torch.int64).max)  # weight-0 entries sort last
    key, order = torch.sort(key, dim=-1, stable=True)  # stable: equal cells keep their sample order
    w, keep = w.gather(-1, order), keep.gather(-1, order)
    first = torch.ones_like(keep)
    first[..., 1:] = key[..., 1:] != key[..., :-1]
    slot = first.cumsum(-1) - 1
    pairs = (first & keep).sum(-1)
    out_cells = torch.zeros_like(cells).scatter_(-1, slot, torch.where(keep, key, 0))
    out_w = torch.zeros_like(w).scatter_add_(-1, slot, w * keep)
    return out_cells, out_w, pairs, count


def _table_chunks(boxes, levels, level_hw, strides, P: int, chunk: int):
    """Per chunk of RoIs: (slice of the flattened RoIs, flat row of each
    RoI's map origin (n,) as ``_roi_chunks``, map width (n,) int64, y-tables,
    x-tables), the tables as ``adaptive_axis_tables`` returns them."""
    for sl, bx, origin, scale, H, W in _roi_chunks(boxes, levels, level_hw, strides, chunk):
        ys = adaptive_axis_tables(bx[:, 1] * scale - 0.5, bx[:, 3] * scale - 0.5, H, P)
        xs = adaptive_axis_tables(bx[:, 0] * scale - 0.5, bx[:, 2] * scale - 0.5, W, P)
        yield sl, origin, W.long(), ys, xs


def _table_weights(ys, xs, dtype):
    """(flat cell offsets (n, P, Ky, P, Kx) from the map origin, their
    weights wy / (n_y n_x) * wx) of a chunk's tables, cut to the chunk's
    widest tables."""
    (cy, wy, ky, ny), (cx, wx, kx, nx) = ys, xs
    Ky, Kx = max(int(ky.max()), 1), max(int(kx.max()), 1)
    wy = wy[..., :Ky].to(dtype) / (ny * nx).to(dtype)[:, None, None]  # the count enters once, with the y-weights
    return cy[..., :Ky], cx[..., :Kx], wy, wx[..., :Kx].to(dtype)


def roi_align_from_tables(feats, boxes, levels, strides, out_size: int = 7, chunk: int = PLAIN_CHUNK // 16):
    """The adaptive grid's forward computed from its axis tables (the
    kernels' formulation; a model for the tests): per bin
    ``sum_e wy_e / (n_y n_x) * sum_q wx_q f[cy_e, cx_q]``, in f32."""
    B, R = boxes.shape[:2]
    C, P = feats[0].shape[-1], out_size
    flat = torch.cat([f.reshape(B, -1, C) for f in feats], dim=1).reshape(-1, C).float()
    out = torch.empty((B * R, P, P, C), dtype=torch.float32, device=boxes.device)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    for sl, base, Wl, ys, xs in _table_chunks(boxes, levels, level_hw, strides, P, chunk):
        cy, cx, wy, wx = _table_weights(ys, xs, torch.float32)
        rows = base[:, None, None] + cy * Wl[:, None, None]  # (n, P, Ky)
        idx = rows[:, :, :, None, None] + cx[:, None, None, :, :]  # (n, P, Ky, P, Kx)
        t = (flat[idx] * wx[:, None, None, :, :, None]).sum(-2)  # the x-pass: (n, P, Ky, P, C)
        out[sl] = (t * wy[..., None, None]).sum(2)  # then the y-pass
    return out.reshape(B, R, P, P, C)


def roi_align_bwd_from_tables(grad, boxes, levels, level_hw, strides, out_size: int = 7,
                              chunk: int = PLAIN_CHUNK // 16, acc_dtype: torch.dtype = torch.float32):
    """The adaptive grid's backward computed from its axis tables (the
    kernels' formulation; a model for the tests): each (RoI, bin) adds
    ``cot * wy_e / (n_y n_x) * wx_q`` to cell (cy_e, cx_q), in ``acc_dtype``."""
    B, R = boxes.shape[:2]
    C, P = grad.shape[-1], out_size
    flat = torch.zeros((B * sum(h * w for h, w in level_hw), C), dtype=acc_dtype, device=grad.device)
    g = grad.reshape(B * R, P, P, C).to(acc_dtype)
    for sl, base, Wl, ys, xs in _table_chunks(boxes, levels, level_hw, strides, P, chunk):
        cy, cx, wy, wx = _table_weights(ys, xs, acc_dtype)
        idx = (base[:, None, None] + cy * Wl[:, None, None])[:, :, :, None, None] + cx[:, None, None, :, :]
        w = wy[:, :, :, None, None] * wx[:, None, None, :, :]  # (n, P, Ky, P, Kx)
        flat.index_add_(0, idx.reshape(-1), (g[sl][:, :, None, :, None, :] * w[..., None]).reshape(-1, C))
    return _split_levels(flat, B, level_hw)


def adaptive_table_widths(boxes, levels, level_hw, strides, out_size: int = 7) -> Tuple[int, int]:
    """(the most pairs of any axis table, the most bins of one RoI that meet
    one row or column of its map) over these RoIs: at most 16 and
    ``out_size``, as ``csrc/roi_align_adaptive.cuh`` proves."""
    widest, most_bins = 0, 0
    for _, _, _, ys, xs in _table_chunks(boxes, levels, level_hw, strides, out_size, PLAIN_CHUNK):
        for cells, _, pairs, _ in (ys, xs):
            widest = max(widest, int(pairs.max()))
            on = torch.arange(cells.shape[-1], device=cells.device) < pairs[..., None]  # (n, P, 2L)
            # bins of a RoI through each cell: a cell is once in a bin's table
            span = int(cells.max()) + 1
            per_cell = torch.zeros((cells.shape[0], span), dtype=torch.int64, device=cells.device)
            per_cell.scatter_add_(1, cells.reshape(cells.shape[0], -1), on.reshape(cells.shape[0], -1).long())
            most_bins = max(most_bins, int(per_cell.max()))
    return widest, most_bins


# ---------------------------------------------------------------- backward


def roi_align_bwd_plain(
    grad: torch.Tensor,
    boxes: torch.Tensor,
    levels: torch.Tensor,
    level_hw: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
    chunk: int = PLAIN_CHUNK,
    acc_dtype: torch.dtype = torch.float32,
) -> List[torch.Tensor]:
    """d(features) of ``roi_align_plain`` for the cotangent ``grad``
    (B, R, P, P, C): per-level (B, H_l, W_l, C) accumulators of ``acc_dtype``.

    f32: the transpose of the gather path, written out: each bilinear
    neighbour receives (cotangent / count) * in_range * weight through an
    f32 ``index_add_``, with the forward's weights, so no bf16 rounding
    enters the sums (autograd through bf16 indexing would accumulate in
    bf16).

    bf16 (K2's ``pallas_bf16`` mode): the TPU kernel's order. Round r takes
    RoI r of every image (the image-interleaved order of
    ``roi_align_v2.py:531-539``; the images' cells are disjoint, so each
    cell sees its image's RoIs in order), sums each RoI's window gradient in
    f32 and adds it to the bf16 accumulator with one rounding per RoI.

    f64: the f32 sums in float64, an oracle for the sum-order error of the
    f32 versions (an f32 ``index_add_`` over tens of thousands of terms per
    cell strays further from the exact sum than the kernel's order does).

    The adaptive grid (``sampling_ratio == ADAPTIVE``) divides each RoI's
    cotangent by its own sample count ``n_y * n_x``, in every mode."""
    if acc_dtype == torch.bfloat16:
        return _roi_align_bwd_plain_bf16(grad, boxes, levels, level_hw, strides, out_size, sampling_ratio)
    if acc_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"accumulators are float32, float64 or bfloat16, not {acc_dtype}")
    B, R = boxes.shape[:2]
    C = grad.shape[-1]
    P, S = out_size, sampling_ratio
    per_image = sum(h * w for h, w in level_hw)
    flat = torch.zeros((B * per_image, C), dtype=acc_dtype, device=grad.device)
    g = grad.reshape(B * R, P, P, C).to(acc_dtype)
    count = torch.full((), float(S * S), dtype=acc_dtype, device=grad.device)  # a tensor divisor, as the forward's mean
    for sl, n, neighbours, ok, counts, (Ly, Lx) in _chunk_geometry(boxes, levels, level_hw, strides, P, S,
                                                                   _chunk(chunk, S)):
        gc = g[sl] / (counts.to(acc_dtype)[:, None, None, None] if S == ADAPTIVE else count)
        gs = gc[:, :, None, :, None, :].expand(n, P, Ly, P, Lx, C).reshape(n, P * Ly, P * Lx, C)
        d = gs * ok[..., None]
        for idx, w in neighbours:
            flat.index_add_(0, idx.reshape(-1), (d * w[..., None]).reshape(-1, C))
    return _split_levels(flat, B, level_hw)


def _split_levels(flat, B, level_hw):
    flat = flat.reshape(B, -1, flat.shape[-1])
    out, start = [], 0
    for h, w in level_hw:
        out.append(flat[:, start : start + h * w].reshape(B, h, w, flat.shape[-1]))
        start += h * w
    return out


def _roi_align_bwd_plain_bf16(grad, boxes, levels, level_hw, strides, P, S):
    B, R = boxes.shape[:2]
    C = grad.shape[-1]
    per_image = sum(h * w for h, w in level_hw)
    flat = torch.zeros((B * per_image, C), dtype=torch.bfloat16, device=grad.device)
    g = grad.float() * (1.0 / (S * S))  # d(mean), as the TPU kernel scales the cotangent
    for r in range(R):
        (_, n, neighbours, ok, counts, (Ly, Lx)), = _chunk_geometry(boxes[:, r : r + 1], levels[:, r : r + 1],
                                                                    level_hw, strides, P, S, chunk=B)
        gr = grad[:, r].float() / counts[:, None, None, None] if S == ADAPTIVE else g[:, r]
        gs = gr[:, :, None, :, None, :].expand(n, P, Ly, P, Lx, C).reshape(n, P * Ly, P * Lx, C)
        d = gs * ok[..., None]
        # the round's window gradients, one f32 sum per touched cell
        idx = torch.cat([i.reshape(-1) for i, _ in neighbours])
        vals = torch.cat([(d * w[..., None]).reshape(-1, C) for _, w in neighbours])
        cells, inverse = torch.unique(idx, return_inverse=True)
        win = torch.zeros((cells.shape[0], C), dtype=torch.float32, device=grad.device).index_add_(0, inverse, vals)
        flat[cells] = (flat[cells].float() + win).to(torch.bfloat16)
    return _split_levels(flat, B, level_hw)


def _check_bwd_inputs(grad, boxes, levels, level_hw, strides, P, S):
    if len(level_hw) != NUM_LEVELS or len(strides) != NUM_LEVELS:
        raise ValueError(f"the kernel pools exactly {NUM_LEVELS} FPN levels, got {len(level_hw)}")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, R, 4) float32, got {tuple(boxes.shape)} {boxes.dtype}")
    B, R = boxes.shape[:2]
    if levels.dtype != torch.int32 or tuple(levels.shape) != (B, R):
        raise ValueError(f"levels must be ({B}, {R}) int32, got {tuple(levels.shape)} {levels.dtype}")
    if grad.dtype != torch.float32 or grad.dim() != 5 or tuple(grad.shape[:4]) != (B, R, P, P):
        raise ValueError(f"grad must be ({B}, {R}, {P}, {P}, C) float32, got {tuple(grad.shape)} {grad.dtype}")
    for t in (grad, boxes, levels):
        if t.device != boxes.device:
            raise ValueError("grad, boxes and levels must be on one device")
        if not t.is_contiguous():
            raise ValueError("grad, boxes and levels must be contiguous")


def _launch_bwd(fn, accs, grad, boxes, levels, level_hw, strides, P, S):
    B, R = boxes.shape[:2]
    lib = _native.load("roi_align_bwd")
    hw = [d for h, w in level_hw for d in (h, w)]
    with torch.cuda.device(boxes.device):
        code = getattr(lib, fn)(
            *[a.data_ptr() for a in accs], *hw, *[1.0 / s for s in strides],
            boxes.data_ptr(), levels.data_ptr(), grad.data_ptr(), B * R, R, grad.shape[-1], P, S,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(lib, fn, code)


def roi_align_bwd(
    grad: torch.Tensor,
    boxes: torch.Tensor,
    levels: torch.Tensor,
    level_hw: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
) -> List[torch.Tensor]:
    """RoIAlignV2 backward (K2, f32 accumulators): per-level
    (B, H_l, W_l, C) f32 accumulators from the (B, R, P, P, C) f32 cotangent,
    a cell's RoIs in index order (so the kernel's result is deterministic):
    on the static grid each RoI's f32 window gradient added once, on the
    adaptive grid once per y-bin of the RoI that meets the cell.
    ``out_size * sampling_ratio`` at most 32, or the adaptive grid
    (``ADAPTIVE``) with ``out_size * 8`` at most 56.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    counted by the tracer as ``kernel.roi_align_bwd`` on the static grid and
    ``kernel.roi_align_bwd.adaptive`` on the adaptive one.
    """
    if boxes.device.type == "cpu":
        return roi_align_bwd_plain(grad, boxes, levels, level_hw, strides, out_size, sampling_ratio)
    if boxes.device.type != "cuda":
        raise ValueError(f"roi_align_bwd runs on CPU or CUDA tensors, not {boxes.device}")
    P, S = out_size, sampling_ratio
    _check_bwd_inputs(grad, boxes, levels, level_hw, strides, P, S)
    _check_grid(P, S, adaptive=True)
    B, C = boxes.shape[0], grad.shape[-1]
    if boxes.numel() == 0:
        return [torch.zeros((B, h, w, C), dtype=torch.float32, device=boxes.device) for h, w in level_hw]
    # the kernel writes every cell, zeros included
    accs = [torch.empty((B, h, w, C), dtype=torch.float32, device=boxes.device) for h, w in level_hw]
    _launch_bwd("roi_align_bwd", accs, grad, boxes, levels, level_hw, strides, P, S)
    tracing.count("kernel.roi_align_bwd.adaptive" if S == ADAPTIVE else "kernel.roi_align_bwd")
    return accs


def roi_align_bwd_bf16(
    grad: torch.Tensor,
    boxes: torch.Tensor,
    levels: torch.Tensor,
    level_hw: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
) -> List[torch.Tensor]:
    """RoIAlignV2 backward in K2's ``pallas_bf16`` mode: per-level
    (B, H_l, W_l, C) **bf16** accumulators, each RoI's f32 window gradient
    added with one rounding per RoI, a cell's RoIs in index order (so the
    kernel's result is deterministic). C must be even and
    ``out_size * sampling_ratio`` at most 16.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if boxes.device.type == "cpu":
        return roi_align_bwd_plain(grad, boxes, levels, level_hw, strides, out_size, sampling_ratio,
                                   acc_dtype=torch.bfloat16)
    if boxes.device.type != "cuda":
        raise ValueError(f"roi_align_bwd_bf16 runs on CPU or CUDA tensors, not {boxes.device}")
    P, S = out_size, sampling_ratio
    _check_bwd_inputs(grad, boxes, levels, level_hw, strides, P, S)
    _check_grid(P, S, adaptive=False)
    B, C = boxes.shape[0], grad.shape[-1]
    if C % 2 or P * S > 16:
        raise ValueError(f"the bf16-accumulator kernel takes an even C (channel pairs) and "
                         f"out_size * sampling_ratio <= 16, got C={C}, {P}*{S}")
    if boxes.numel() == 0:
        return [torch.zeros((B, h, w, C), dtype=torch.bfloat16, device=boxes.device) for h, w in level_hw]
    # the kernel writes every cell, zeros included
    accs = [torch.empty((B, h, w, C), dtype=torch.bfloat16, device=boxes.device) for h, w in level_hw]
    _launch_bwd("roi_align_bwd_bf16", accs, grad, boxes, levels, level_hw, strides, P, S)
    tracing.count("kernel.roi_align_bwd_bf16")
    return accs


class RoIAlignFunction(torch.autograd.Function):
    """Differentiable multilevel RoIAlign: ``roi_align`` forward; backward
    by ``roi_align_bwd`` (``acc_dtype`` float32) or ``roi_align_bwd_bf16``
    (bfloat16), the accumulators rounded to the features' dtype. It saves the
    boxes, the levels and the level shapes, not the features. Call as
    ``RoIAlignFunction.apply(boxes, levels, strides, out_size,
    sampling_ratio, acc_dtype, *feats)``. The forward goes through the
    custom operator (``roi_align``), so training, serving and an exported
    program reach K1 by one route; ``torch.export`` inlines the forward."""

    @staticmethod
    def forward(ctx, boxes, levels, strides, out_size, sampling_ratio, acc_dtype, *feats):
        if acc_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"accumulators are float32 or bfloat16, not {acc_dtype}")
        ctx.save_for_backward(boxes, levels)
        ctx.args = (tuple(strides), out_size, sampling_ratio, [(f.shape[1], f.shape[2]) for f in feats],
                    feats[0].dtype, acc_dtype)
        return roi_align(list(feats), boxes, levels, strides, out_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        boxes, levels = ctx.saved_tensors
        strides, out_size, sampling_ratio, level_hw, dtype, acc_dtype = ctx.args
        bwd = roi_align_bwd_bf16 if acc_dtype == torch.bfloat16 else roi_align_bwd
        accs = bwd(grad.contiguous(), boxes, levels, level_hw, strides, out_size, sampling_ratio)
        return (None,) * 6 + tuple(a.to(dtype) for a in accs)
