"""Multilevel RoIAlign (V2 / aligned=True) for the reference: level
assignment and the plain gather formulation only.

Frozen copy of ``openset_rcnn_tpu_torch/ops/roi_align.py`` (level rules,
``_sample_axis``, ``roi_align_plain`` and its chunk geometry), without the
kernel wrappers and operators. ``roi_align_plain`` is differentiable in the
features by autograd: its backward is the transpose of the gather, an f32
``index_add`` per neighbour, which is what the RoIAlign backward computes.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


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
