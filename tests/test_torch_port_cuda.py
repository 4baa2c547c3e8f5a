"""CUDA kernels of the PyTorch port against their plain PyTorch versions.

These need an NVIDIA GPU and skip without one. On a machine with the card
(which need not have JAX), run them with:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

The plain versions themselves are held against the JAX package on the CPU
(tests/test_torch_port_ops.py, tests/test_torch_port_train_ops.py).
"""
import math

import pytest
import torch

from openset_rcnn_tpu_torch.ops.iou_match import iou_match, iou_match_plain
from openset_rcnn_tpu_torch.ops.nms import nms_keep, nms_keep_plain
from openset_rcnn_tpu_torch.ops.roi_align import (
    RoIAlignFunction,
    assign_levels,
    assign_levels_window_fit,
    roi_align,
    roi_align_bwd,
    roi_align_bwd_bf16,
    roi_align_bwd_plain,
    roi_align_plain,
    roi_align_window,
    roi_align_window_plain,
)

pytestmark = pytest.mark.cuda
STRIDES = (4, 8, 16, 32)
BWD_TOL = 1e-5  # RoIAlign backward, scaled by max(1, max|want|): the plain version sums in another order
# bf16 accumulators, kernel vs plain: both round each RoI's f32 window sum
# into the cell once, RoI after RoI in index order, but they add up each
# window sum in another order, so a window sum may differ in its last bits
# and round the other way: 4 bf16 steps (2^-5) of the cell plus one step of
# the largest cell (a loose limit; PERF.md gives the errors measured)
BF16_ACC_RTOL, BF16_ACC_ATOL = 2.0**-5, 2.0**-7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def roi_inputs(dev, B, R, C, hw=(256, 384), seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    H, W = hw
    feats = [torch.randn(B, -(-H // s), -(-W // s), C, generator=g, device=dev).to(torch.bfloat16) for s in STRIDES]
    side = torch.exp(2.0 + u(B, R) * 4.2)  # 7 .. 490 px: all four levels
    ar = torch.exp(u(B, R) * 4.4 - 2.2)    # aspect 0.11 .. 9
    w, h = side * ar.sqrt(), side / ar.sqrt()
    cx, cy = u(B, R) * W, u(B, R) * H
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)  # some cross the edge
    boxes[:, : R // 4, 2:] = boxes[:, : R // 4, :2] + u(B, R // 4, 2)  # tiny
    return feats, boxes.contiguous()


@pytest.mark.parametrize("C", [256, 200, 32, 100])  # 100: a masked tail of the 8-channel vectors
def test_roi_align_kernel_matches_plain(dev, C):
    feats, boxes = roi_inputs(dev, 3, 301, C, seed=C)
    levels = assign_levels(boxes)
    before = roi_align.launches
    got = roi_align(feats, boxes, levels, STRIDES)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 1
    want = roi_align_plain(feats, boxes, levels, STRIDES)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("P,S", [(7, 3), (5, 2), (14, 1)])
def test_roi_align_kernel_generic_grid_matches_plain(dev, P, S):
    """(P, S) other than the config's (7, 2) take the kernel's generic
    instantiation: still bitwise the plain version's arithmetic."""
    feats, boxes = roi_inputs(dev, 2, 97, 64, seed=P * 10 + S)
    levels = assign_levels(boxes)
    got = roi_align(feats, boxes, levels, STRIDES, P, S)
    torch.cuda.synchronize()
    assert got.shape == (2, 97, P, P, 64)
    torch.testing.assert_close(got, roi_align_plain(feats, boxes, levels, STRIDES, P, S), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 4104), (torch.float32, 2052)])
def test_roi_align_kernels_wide_channels(dev, dtype, C):
    """More channel groups than a block has threads (8 bf16 or 4 f32
    channels per thread, 512 threads): each thread loops over its groups."""
    feats, boxes = roi_inputs(dev, 1, 16, C, hw=(64, 96), seed=C)
    feats = [f.to(dtype) for f in feats]
    levels = assign_levels(boxes)
    if dtype == torch.bfloat16:
        got, want = roi_align(feats, boxes, levels, STRIDES), roi_align_plain(feats, boxes, levels, STRIDES)
    else:
        got, want = roi_align_window(feats, boxes, STRIDES), roi_align_window_plain(feats, boxes, STRIDES)
    torch.cuda.synchronize()
    assert got.shape == (1, 16, 7, 7, C)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


def test_roi_align_kernel_rejects_what_it_does_not_take(dev):
    feats, boxes = roi_inputs(dev, 1, 8, 32)
    levels = assign_levels(boxes)
    with pytest.raises(ValueError, match="bfloat16"):
        roi_align([f.float() for f in feats], boxes, levels, STRIDES)
    with pytest.raises(ValueError, match="contiguous"):
        roi_align([f.transpose(1, 2) for f in feats], boxes, levels, STRIDES)
    with pytest.raises(ValueError, match="int32"):
        roi_align(feats, boxes, levels.long(), STRIDES)


def adaptive_boxes(dev, B, R, hw=(256, 384), seed=0):
    """Boxes of sides 8-800 px over a (hw) canvas, elongated ones among them,
    so that the adaptive grid takes 1 sample a bin (tiny boxes), 2-4 and the
    clip at 8 (long sides at their level), some across the edge."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    H, W = hw
    side = torch.exp(math.log(8.0) + u(B, R) * math.log(100.0))
    ar = torch.exp(u(B, R) * 2.0 - 1.0)
    n = R // 6
    ar[:, :n] = 6.0 + 10.0 * u(B, n)              # wide: 8 samples a bin across
    ar[:, n : 2 * n] = 1.0 / (6.0 + 10.0 * u(B, n))  # tall
    w, h = side * ar.sqrt(), side / ar.sqrt()
    cx, cy = u(B, R) * W, u(B, R) * H
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    boxes[:, 2 * n : 3 * n, 2:] = boxes[:, 2 * n : 3 * n, :2] + 0.5 + u(B, n, 2)  # tiny: 1 sample a bin
    return boxes.contiguous()


def adaptive_counts(boxes, levels):
    """The adaptive grid's samples per bin axis of each RoI (1 to 8)."""
    scale = 1.0 / torch.tensor(STRIDES, dtype=torch.float32, device=boxes.device)[levels.long()]
    ext = torch.stack([boxes[..., 3] - boxes[..., 1], boxes[..., 2] - boxes[..., 0]], -1) * scale[..., None]
    return torch.clamp(torch.ceil(ext / torch.full_like(ext, 7.0)), 1, 8)


@pytest.mark.parametrize("C", [256, 100])  # 100: a masked tail of the 8-channel vectors
def test_roi_align_kernel_adaptive_matches_plain(dev, C):
    """The adaptive grid (sampling_ratio -1): K1's third instantiation,
    bitwise the plain version's arithmetic (held here at atol 2e-5 + rtol
    1e-5), counted apart from the static grid's launches."""
    feats, _ = roi_inputs(dev, 2, 8, C, seed=C)
    boxes = adaptive_boxes(dev, 2, 300, seed=C)
    levels = assign_levels(boxes)
    counts = adaptive_counts(boxes, levels)
    assert float(counts.min()) == 1.0 and float(counts.max()) == 8.0
    before, static = roi_align.adaptive_launches, roi_align.launches
    got = roi_align(feats, boxes, levels, STRIDES, 7, -1)
    torch.cuda.synchronize()
    assert (roi_align.adaptive_launches, roi_align.launches) == (before + 1, static)
    torch.testing.assert_close(got, roi_align_plain(feats, boxes, levels, STRIDES, 7, -1), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("C", [256, 98])  # 98: C % 4 != 0, scalar loads and stores
def test_roi_align_bwd_kernel_adaptive_matches_plain(dev, C):
    """K2 f32 on the adaptive grid against its plain version, within
    1e-5 * max(1, max|want|), counted apart from the static grid's."""
    feats, _ = roi_inputs(dev, 2, 8, C, seed=C)
    boxes = adaptive_boxes(dev, 2, 300, seed=C + 1)
    levels = assign_levels(boxes)
    g = torch.Generator(device=dev).manual_seed(C)
    cot = torch.randn(2, 300, 7, 7, C, generator=g, device=dev)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    before, static = roi_align_bwd.adaptive_launches, roi_align_bwd.launches
    got = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, 7, -1)
    torch.cuda.synchronize()
    assert (roi_align_bwd.adaptive_launches, roi_align_bwd.launches) == (before + 1, static)
    assert_bwd_close(got, roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, 7, -1))


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
@pytest.mark.parametrize("B", [4, 16])
def test_roi_align_bwd_kernel_adaptive_is_deterministic(dev, B, kind):
    """K2 f32 on the adaptive grid: two launches bitwise equal."""
    feats, _ = roi_inputs(dev, B, 8, 256, seed=30 + B)
    boxes = adaptive_boxes(dev, B, 128, seed=31 + B) if kind == "uniform" else \
        clustered_boxes(dev, B, 128, (256, 384), 4, 0.3, seed=32 + B)
    levels = assign_levels(boxes)
    g = torch.Generator(device=dev).manual_seed(B)
    cot = torch.randn(B, 128, 7, 7, 256, generator=g, device=dev)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    first = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, 7, -1)
    second = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, 7, -1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert_bwd_close(first, roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, 7, -1))


def test_adaptive_grid_only_in_k1_and_k2_f32(dev):
    """K2's bf16 mode and K5 have no adaptive mode; the adaptive lattice
    takes out_size * 8 <= 56."""
    feats, boxes, levels, cot = bwd_inputs(dev, 1, 8, 32, seed=0)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    with pytest.raises(ValueError, match="not the adaptive grid"):
        roi_align_bwd_bf16(cot, boxes, levels, level_hw, STRIDES, 7, -1)
    with pytest.raises(ValueError, match="not the adaptive grid"):
        roi_align_window(feats, boxes, STRIDES, 7, -1)
    with pytest.raises(ValueError, match="56"):
        roi_align(feats, boxes, levels, STRIDES, 8, -1)


def nms_inputs(dev, B, N, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    ctr = u(B, N, 2) * 200.0
    wh = 10.0 + u(B, N, 2) * 100.0
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    k = min(N // 2, 20)
    x = torch.floor(u(B, k) * 150.0)
    boxes[:, 0 : 2 * k : 2] = torch.stack([x, x, x + 20, x + 20], -1)  # IoU exactly 0.5
    boxes[:, 1 : 2 * k : 2] = torch.stack([x, x, x + 20, x + 10], -1)
    return boxes.contiguous(), u(B, N) > 0.2


@pytest.mark.parametrize("N", [1, 33, 1000, 2000, 3000])
@pytest.mark.parametrize("thresh", [0.5, 0.7])
def test_nms_kernel_matches_plain(dev, N, thresh):
    boxes, valid = nms_inputs(dev, 4, N, seed=N)
    before = nms_keep.launches
    got = nms_keep(boxes, valid, thresh)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    assert torch.equal(got, nms_keep_plain(boxes, valid, thresh))
    assert not got[~valid].any()


# 64 rows per mask word, 32 words per lane of the walking warp: 2048 rows
# fill one word per lane, 4100 needs three (more words than lanes), and the
# walk's shared memory then exceeds 48 KB
@pytest.mark.parametrize("N", [1, 63, 64, 65, 2047, 2048, 2049, 4100])
def test_nms_kernel_word_and_lane_boundaries(dev, N):
    boxes, valid = nms_inputs(dev, 3, N, seed=N + 1)
    before = nms_keep.launches
    got = nms_keep(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    assert torch.equal(got, nms_keep_plain(boxes, valid, 0.5))


@pytest.mark.parametrize("case", ["all_invalid", "all_identical", "thresh_0", "thresh_1", "class_offset"])
def test_nms_kernel_edge_cases(dev, case):
    """Exactly the plain version: nothing valid; every box the same (only
    the first survives); threshold 0 (any overlap suppresses) and 1 (strict
    '>': nothing suppresses); the known branch's class-offset input (20
    classes shifted apart, most rows kept)."""
    boxes, valid = nms_inputs(dev, 2, 700, seed=17)
    thresh = {"thresh_0": 0.0, "thresh_1": 1.0}.get(case, 0.5)
    if case == "all_invalid":
        valid = torch.zeros_like(valid)
    elif case == "all_identical":
        boxes = boxes[:, :1].expand_as(boxes).contiguous()
        valid = torch.ones_like(valid)
    elif case == "class_offset":
        g = torch.Generator(device=dev).manual_seed(18)
        cls = (torch.rand(valid.shape, generator=g, device=dev) * 20).floor()
        boxes = (boxes + (cls * (boxes.amax(dim=(1, 2)) + 1.0)[:, None])[..., None]).contiguous()
    before = nms_keep.launches
    got = nms_keep(boxes, valid, thresh)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    want = nms_keep_plain(boxes, valid, thresh)
    assert torch.equal(got, want)
    if case == "all_invalid":
        assert not got.any()
    elif case == "all_identical":
        assert got[:, 0].all() and not got[:, 1:].any()
    elif case == "thresh_1":
        assert torch.equal(got, valid)
    elif case == "class_offset":
        assert int(got.sum()) > int(nms_keep_plain(*nms_inputs(dev, 2, 700, seed=17), 0.5).sum())


def test_nms_kernel_rejects_what_it_does_not_take(dev):
    boxes, valid = nms_inputs(dev, 2, 64)
    with pytest.raises(ValueError, match="float32"):
        nms_keep(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError, match="bool"):
        nms_keep(boxes, valid.float(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        nms_keep(boxes.transpose(0, 1).contiguous().transpose(0, 1), valid, 0.5)


def iou_inputs(dev, B, G, R, seed=0):
    """Anchors and padded GT with integer corners among them (exact IoU
    ties), a zero-area GT, a duplicate GT row and, for B > 1, a last image
    without valid GT."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)

    def boxes(*shape, lo, hi):
        xy = u(*shape, 2) * 1000.0
        return torch.cat([xy, xy + lo + u(*shape, 2) * (hi - lo)], -1)

    anchors = boxes(R, lo=8.0, hi=400.0)
    anchors[::2] = anchors[::2].round()
    gt = boxes(B, G, lo=20.0, hi=400.0)
    gt[0] = gt[0].round()
    valid = u(B, G) > 0.3
    valid[0] = True
    if G > 2:
        gt[0, 1] = torch.tensor([100.0, 100.0, 100.0, 160.0], device=dev)  # zero area
        gt[0, 2] = gt[0, 3]
    if B > 1:
        valid[-1] = False
    return anchors.contiguous(), gt.contiguous(), valid


@pytest.mark.parametrize("B,G,R", [(1, 1, 1000), (2, 1, 4097), (3, 37, 20000), (4, 100, 93093)])
def test_iou_match_kernel_matches_plain(dev, B, G, R):
    anchors, gt, valid = iou_inputs(dev, B, G, R, seed=G + R)
    before = iou_match.launches
    got = iou_match(anchors, gt, valid)
    torch.cuda.synchronize()
    assert iou_match.launches == before + 2
    want = iou_match_plain(anchors, gt, valid)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert want.rescued[0].any()
    if B > 1:
        assert (got.max_iou[-1] == -1).all() and not got.rescued[-1].any()


@pytest.mark.parametrize("B,G,R", [(16, 100, 93093), (2, 1024, 20000), (5, 1024, 20000)])
def test_iou_match_kernel_exact_on_ties(dev, B, G, R):
    """Integer anchors against integer GT (exact IoU ties), a duplicate GT
    row, a zero-area GT and a last image without valid GT, at the train_bf16
    batch and at the largest G the kernel takes: all four outputs exactly
    the plain version's."""
    anchors, gt, valid = iou_inputs(dev, B, G, R, seed=B + G + R)
    got = iou_match(anchors, gt, valid)
    torch.cuda.synchronize()
    want = iou_match_plain(anchors, gt, valid)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    m = want.max_iou[0]
    assert len(torch.unique(m[m > 0])) < int((m > 0).sum())  # tied IoUs
    assert want.rescued[0].any()
    assert (got.max_iou[-1] == -1).all() and (got.matched_idx[-1] == 0).all() and not got.rescued[-1].any()
    assert torch.equal(got.matched_boxes[-1], gt[-1, :1].expand(R, 4))


def test_iou_match_kernel_issues_two_device_operations(dev):
    """A call is its two kernels and nothing else: no fill, no memset."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    anchors, gt, valid = iou_inputs(dev, 4, 100, 93093, seed=3)
    iou_match(anchors, gt, valid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        iou_match(anchors, gt, valid)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(ops) == 2, ops
    assert any("iou_match_best_kernel" in n for n in ops) and any("iou_match_rescue_kernel" in n for n in ops), ops


def test_iou_match_kernel_rejects_what_it_does_not_take(dev):
    anchors, gt, valid = iou_inputs(dev, 2, 5, 64)
    with pytest.raises(ValueError, match="float32"):
        iou_match(anchors.double(), gt, valid)
    with pytest.raises(ValueError, match="bool"):
        iou_match(anchors, gt, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        iou_match(anchors.t().contiguous().t(), gt, valid)
    big, big_valid = iou_inputs(dev, 1, 1025, 64)[1:]
    with pytest.raises(ValueError, match="1 to 1024"):
        iou_match(anchors, big, big_valid)


def bwd_inputs(dev, B, R, C, seed):
    feats, boxes = roi_inputs(dev, B, R, C, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    cot = torch.randn(B, R, 7, 7, C, generator=g, device=dev)
    return feats, boxes, assign_levels(boxes), cot


def assert_bwd_close(got, want, rtol=0.0):
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w, atol=BWD_TOL * scale, rtol=rtol)


# 200, 100: some lanes hold one float4 group or none; 98: C % 4 != 0, scalar loads and atomics
@pytest.mark.parametrize("C", [256, 200, 32, 100, 98])
def test_roi_align_bwd_kernel_matches_plain(dev, C):
    feats, boxes, levels, cot = bwd_inputs(dev, 3, 301, C, seed=C)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    before = roi_align_bwd.launches
    got = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES)
    torch.cuda.synchronize()
    assert roi_align_bwd.launches == before + 1
    assert all(a.dtype == torch.float32 and a.shape == (3, h, w, C) for a, (h, w) in zip(got, level_hw))
    assert_bwd_close(got, roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES))


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
@pytest.mark.parametrize("B", [4, 16])
def test_roi_align_bwd_kernel_is_deterministic(dev, B, kind):
    """K2 f32 has no atomics and applies each cell's RoIs in index order:
    two launches on the same inputs are bitwise equal, at the f32 and the
    train_bf16 batch, on uniform RoIs and on RoIs clustered over few cells."""
    feats, boxes, levels, cot = bwd_inputs(dev, B, 128, 256, seed=20 + B)
    if kind == "clustered":
        boxes = clustered_boxes(dev, B, 128, (256, 384), 4, 0.3, seed=21 + B)
        levels = assign_levels(boxes)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    first = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES)
    second = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert_bwd_close(first, roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES))


# P * S = 32, the widest grid K2 f32 takes; 98 and 30: C % 4 != 0, scalar loads and stores
@pytest.mark.parametrize("P,S,C", [(16, 2, 64), (8, 4, 98), (32, 1, 30)])
def test_roi_align_bwd_kernel_widest_grid(dev, P, S, C):
    feats, boxes = roi_inputs(dev, 2, 61, C, seed=P * 10 + S)
    levels = assign_levels(boxes)
    g = torch.Generator(device=dev).manual_seed(P + S + C)
    cot = torch.randn(2, 61, P, P, C, generator=g, device=dev)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    got = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, S)
    torch.cuda.synchronize()
    assert_bwd_close(got, roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, S))


def test_roi_align_bwd_kernel_rejects_what_it_does_not_take(dev):
    feats, boxes, levels, cot = bwd_inputs(dev, 1, 8, 32, seed=0)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    with pytest.raises(ValueError, match="float32"):
        roi_align_bwd(cot.double(), boxes, levels, level_hw, STRIDES)
    with pytest.raises(ValueError, match="int32"):
        roi_align_bwd(cot, boxes, levels.long(), level_hw, STRIDES)
    with pytest.raises(ValueError, match="contiguous"):
        roi_align_bwd(cot.transpose(2, 3), boxes, levels, level_hw, STRIDES)


def test_roi_align_function_runs_both_kernels(dev):
    """Autograd through RoIAlignFunction: one forward and one backward
    launch; bf16 feature gradients within one bf16 rounding of the plain
    backward; no gradient for the boxes."""
    feats, boxes, levels, cot = bwd_inputs(dev, 2, 150, 64, seed=7)
    feats = [f.requires_grad_(True) for f in feats]
    fwd, bwd = roi_align.launches, roi_align_bwd.launches
    out = RoIAlignFunction.apply(boxes.requires_grad_(True), levels, STRIDES, 7, 2, torch.float32, *feats)
    out.backward(cot)
    torch.cuda.synchronize()
    assert (roi_align.launches, roi_align_bwd.launches) == (fwd + 1, bwd + 1)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    want = roi_align_bwd_plain(cot, boxes.detach(), levels, level_hw, STRIDES)
    assert all(f.grad.dtype == torch.bfloat16 for f in feats)
    assert_bwd_close([f.grad for f in feats], want, rtol=2.0**-8)
    assert boxes.grad is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [256, 200, 32, 100])
def test_roi_align_window_kernel_matches_plain(dev, C, dtype):
    """K5: window-fit levels (some RoIs bumped), output in the features'
    dtype. f32 at the JAX kernel's tolerance; bf16 within one rounding (the
    f32 values agree, their bf16 roundings may differ by one step)."""
    feats, boxes = roi_inputs(dev, 3, 301, C, seed=C)
    feats = [f.to(dtype) for f in feats]
    assert bool((assign_levels_window_fit(boxes, STRIDES) != assign_levels(boxes)).any())
    before = roi_align_window.launches
    got = roi_align_window(feats, boxes, STRIDES)
    torch.cuda.synchronize()
    assert roi_align_window.launches == before + 1
    assert got.dtype == dtype and got.shape == (3, 301, 7, 7, C)
    want = roi_align_window_plain(feats, boxes, STRIDES)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=2.0**-7)


def test_roi_align_window_kernel_rejects_what_it_does_not_take(dev):
    feats, boxes = roi_inputs(dev, 1, 8, 32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        roi_align_window([f.double() for f in feats], boxes, STRIDES)
    with pytest.raises(ValueError, match="one dtype"):
        roi_align_window([feats[0].float(), *feats[1:]], boxes, STRIDES)
    with pytest.raises(ValueError, match="contiguous"):
        roi_align_window([f.transpose(1, 2) for f in feats], boxes, STRIDES)


@pytest.mark.parametrize("C", [256, 200, 32, 98])  # 98: a masked tail of the 8-channel stores
def test_roi_align_bwd_bf16_kernel_matches_plain(dev, C):
    """K2's pallas_bf16 mode: bf16 accumulators in device memory, within the
    stated tolerance of the plain version's, and within the JAX suite's band
    (rtol 3e-2, atol 5e-2) of the f32 accumulators."""
    feats, boxes, levels, cot = bwd_inputs(dev, 3, 301, C, seed=C)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    before = roi_align_bwd_bf16.launches
    got = roi_align_bwd_bf16(cot, boxes, levels, level_hw, STRIDES)
    torch.cuda.synchronize()
    assert roi_align_bwd_bf16.launches == before + 1
    assert all(a.dtype == torch.bfloat16 and a.shape == (3, h, w, C) for a, (h, w) in zip(got, level_hw))
    want = roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, acc_dtype=torch.bfloat16)
    scale = max(1.0, max(float(w.float().abs().max()) for w in want))
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), rtol=BF16_ACC_RTOL, atol=BF16_ACC_ATOL * scale)
    for a, w in zip(got, roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES)):
        torch.testing.assert_close(a.float(), w, rtol=3e-2, atol=5e-2)


def test_roi_align_bwd_bf16_kernel_rejects_what_it_does_not_take(dev):
    feats, boxes, levels, cot = bwd_inputs(dev, 1, 8, 32, seed=0)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    with pytest.raises(ValueError, match="even C"):
        roi_align_bwd_bf16(cot[..., :31].contiguous(), boxes, levels, level_hw, STRIDES)
    with pytest.raises(ValueError, match="<= 16"):
        roi_align_bwd_bf16(torch.zeros(1, 8, 7, 7, 32, device=dev), boxes, levels, level_hw, STRIDES, 7, 3)
    with pytest.raises(ValueError, match="float32"):
        roi_align_bwd_bf16(cot.double(), boxes, levels, level_hw, STRIDES)


def test_roi_align_function_runs_the_bf16_backward(dev):
    """Autograd with bf16 accumulators: one K1 and one bf16-backward launch,
    the f32 kernel not at all."""
    feats, boxes, levels, cot = bwd_inputs(dev, 2, 150, 64, seed=8)
    feats = [f.requires_grad_(True) for f in feats]
    counts = roi_align.launches, roi_align_bwd.launches, roi_align_bwd_bf16.launches
    out = RoIAlignFunction.apply(boxes, levels, STRIDES, 7, 2, torch.bfloat16, *feats)
    out.backward(cot)
    torch.cuda.synchronize()
    assert (roi_align.launches, roi_align_bwd.launches, roi_align_bwd_bf16.launches) == (
        counts[0] + 1, counts[1], counts[2] + 1)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    want = roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, acc_dtype=torch.bfloat16)
    scale = max(1.0, max(float(w.float().abs().max()) for w in want))
    for f, w in zip(feats, want):
        assert f.grad.dtype == torch.bfloat16
        torch.testing.assert_close(f.grad.float(), w.float(), rtol=BF16_ACC_RTOL, atol=BF16_ACC_ATOL * scale)


def assert_bf16_acc_close(got, want):
    scale = max(1.0, max(float(w.float().abs().max()) for w in want))
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), rtol=BF16_ACC_RTOL, atol=BF16_ACC_ATOL * scale)


def clustered_boxes(dev, B, R, hw, n_centres, jitter, seed):
    """RoIs jittered around a few boxes per image, as the ROI sampler draws
    them around the GT: many RoIs over the same cells."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    H, W = hw
    wh = 16.0 + u(B, n_centres, 2) * torch.tensor([W / 3, H / 3], device=dev)
    xy = u(B, n_centres, 2) * (torch.tensor([W, H], device=dev) - wh)
    centres = torch.cat([xy, xy + wh], -1)
    pick = (u(B, R) * n_centres).long()
    base = torch.gather(centres, 1, pick[..., None].expand(B, R, 4))
    side = torch.cat([base[..., 2:] - base[..., :2]] * 2, -1)
    return (base + (u(B, R, 4) - 0.5) * jitter * side).contiguous()


def test_roi_align_bwd_bf16_kernel_is_deterministic(dev):
    """No atomics and each cell's RoIs in index order: two launches on the
    same inputs are bitwise equal, on uniform and on clustered RoIs."""
    feats, boxes, levels, cot = bwd_inputs(dev, 3, 301, 256, seed=11)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    clustered = clustered_boxes(dev, 3, 301, (256, 384), 4, 0.3, seed=12)
    for bx in (boxes, clustered):
        lv = assign_levels(bx)
        first = roi_align_bwd_bf16(cot, bx, lv, level_hw, STRIDES)
        second = roi_align_bwd_bf16(cot, bx, lv, level_hw, STRIDES)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        assert_bf16_acc_close(first, roi_align_bwd_plain(cot, bx, lv, level_hw, STRIDES, acc_dtype=torch.bfloat16))


def test_roi_align_bwd_bf16_kernel_hot_tile(dev):
    """Hundreds of RoIs over one region of one image: one tile applies them
    all in index order; the other image stays untouched (zeros written)."""
    B, R, C = 2, 600, 64
    g = torch.Generator(device=dev).manual_seed(13)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    xy = 100.0 + u(B, R, 2) * 8.0
    boxes = torch.cat([xy, xy + 20.0 + u(B, R, 2) * 8.0], -1)  # all at P2, all over the same cells
    boxes[1] = boxes[0]
    levels = assign_levels(boxes)
    levels[1] = 3  # image 1: everything at P5, nothing at P2
    cot = torch.randn(B, R, 7, 7, C, generator=g, device=dev)
    level_hw = [(-(-256 // s), -(-384 // s)) for s in STRIDES]
    got = roi_align_bwd_bf16(cot, boxes, levels, level_hw, STRIDES)
    torch.cuda.synchronize()
    assert int((levels[0] == 0).sum()) == R
    want = roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, acc_dtype=torch.bfloat16)
    assert_bf16_acc_close(got, want)
    assert not got[0][1].any() and not got[3][0].any()


def edge_boxes(dev, B, R, H, W, seed):
    """RoIs clamped at every map edge (partly or wholly outside the image),
    on random levels, some spanning the whole map."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    side = 8.0 + u(B, R) * 300.0
    cx = torch.where(u(B, R) < 0.5, u(B, R) * 30.0 - 15.0, W + u(B, R) * 30.0 - 15.0)
    cy = u(B, R) * H
    boxes = torch.stack([cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2], -1)
    swap = u(B, R) < 0.5  # half at the top and bottom edges instead
    top = torch.where(u(B, R) < 0.5, u(B, R) * 30.0 - 15.0, H + u(B, R) * 30.0 - 15.0)
    boxes[swap] = torch.stack([cy[swap] - side[swap] / 2, top[swap] - side[swap] / 2,
                               cy[swap] + side[swap] / 2, top[swap] + side[swap] / 2], -1)
    boxes[:, :8] = torch.tensor([-50.0, -50.0, W + 50.0, H + 50.0], device=dev)  # the whole map and beyond
    boxes[:, 8:16] = torch.tensor([W + 10.0, H + 10.0, W + 60.0, H + 60.0], device=dev)  # wholly outside
    levels = torch.randint(0, 4, (B, R), generator=g, device=dev, dtype=torch.int32)  # every level
    return boxes.contiguous(), levels, g


def test_roi_align_bwd_bf16_kernel_edges_tiles_and_levels(dev):
    """RoIs clamped at every map edge (partly or wholly outside the image),
    RoIs spanning many tiles, on every level, on maps whose sides are not
    multiples of the tile."""
    B, R, C = 2, 256, 32
    H, W = 200, 328  # P2 50 x 82: ragged against 8 x 16 tiles
    boxes, levels, g = edge_boxes(dev, B, R, H, W, seed=14)
    cot = torch.randn(B, R, 7, 7, C, generator=g, device=dev)
    level_hw = [(-(-H // s), -(-W // s)) for s in STRIDES]
    got = roi_align_bwd_bf16(cot, boxes, levels, level_hw, STRIDES)
    torch.cuda.synchronize()
    assert_bf16_acc_close(got, roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, acc_dtype=torch.bfloat16))


def test_roi_align_bwd_kernel_edges_and_outside(dev):
    """K2 f32: RoIs clamped at every map edge, wholly outside the map (every
    sample out of range: nothing to add) and over the whole map, on every
    level."""
    B, R, C = 2, 256, 64
    H, W = 200, 328
    boxes, levels, g = edge_boxes(dev, B, R, H, W, seed=15)
    levels[:, 8:16] = 0  # past the P2 map's last row and column (coarser maps round up and reach them)
    cot = torch.randn(B, R, 7, 7, C, generator=g, device=dev)
    level_hw = [(-(-H // s), -(-W // s)) for s in STRIDES]
    got = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES)
    torch.cuda.synchronize()
    assert_bwd_close(got, roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES))
    outside = torch.zeros_like(cot)
    outside[:, 8:16] = cot[:, 8:16]  # only the RoIs wholly outside the map
    assert not any(a.any() for a in roi_align_bwd(outside, boxes, levels, level_hw, STRIDES))


def test_roi_align_bwd_kernel_hot_cell(dev):
    """K2 f32: 600 RoIs of one image over one spot, all applied to the same
    few cells in index order. Held to the same sums in f64 (the plain
    version's f64 mode): over the tens of thousands of terms of such a cell
    the f32 plain version's own order strays from them by about the whole
    tolerance, the TPU kernel's order (a window sum per RoI) far less."""
    B, R, C = 2, 600, 256
    g = torch.Generator(device=dev).manual_seed(16)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    xy = 100.0 + u(B, R, 2) * 2.0
    boxes = torch.cat([xy, xy + 4.0 + u(B, R, 2) * 2.0], -1).contiguous()  # P2, at most four cells a side
    levels = assign_levels(boxes)
    assert int((levels == 0).sum()) == B * R
    cot = torch.randn(B, R, 7, 7, C, generator=g, device=dev)
    level_hw = [(-(-256 // s), -(-384 // s)) for s in STRIDES]
    got = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES)
    torch.cuda.synchronize()
    want = [w.float() for w in roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, acc_dtype=torch.float64)]
    assert_bwd_close(got, want)
    assert int((want[0][0].abs().sum(-1) > 0).sum()) <= 16


@pytest.mark.parametrize("P,S", [(7, 3), (14, 2)])  # P * S above the bf16 mode's 16
def test_roi_align_bwd_kernel_generic_grid(dev, P, S):
    feats, boxes = roi_inputs(dev, 2, 97, 64, seed=P * 10 + S)
    levels = assign_levels(boxes)
    g = torch.Generator(device=dev).manual_seed(P + S)
    cot = torch.randn(2, 97, P, P, 64, generator=g, device=dev)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    got = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, S)
    torch.cuda.synchronize()
    assert_bwd_close(got, roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, S))


# ------------------------------------------------------------ entry points on the card


def small_trainer_batch(dev, cfg, B=2, H=64, W=96, G=8):
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    g = torch.Generator().manual_seed(9)
    u = lambda *s: torch.rand(*s, generator=g)
    xy, wh = u(B, G, 2) * 50.0, 10.0 + u(B, G, 2) * 30.0
    classes = torch.randint(0, 81, (B, G), generator=g, dtype=torch.int32)
    classes[:, 0] = 3  # a known class in every image
    images = torch.tensor(cfg.MODEL.PIXEL_MEAN) + (u(B, H, W, 3) * 8.0 - 4.0)
    return ImageBatch(images.to(dev), torch.tensor([[H, W]] * B, dtype=torch.float32, device=dev),
                      GroundTruth(torch.cat([xy, xy + wh], -1).to(dev), classes.to(dev), torch.ones(B, G, dtype=torch.bool, device=dev)))


@pytest.mark.parametrize("config", ["openset_rcnn_R50_FPN_128k.yaml", "openset_rcnn_R50_FPN_128k_tpu.yaml"])
def test_train_step_repeats_bitwise_on_the_card(dev, config):
    """Two Trainer.steps from one state on one batch give bitwise equal
    parameters: the step runs cuDNN's deterministic algorithms."""
    import copy
    from pathlib import Path

    from openset_rcnn_tpu_torch.config import get_default_cfg
    from openset_rcnn_tpu_torch.engine.train_state import Trainer

    cfg = get_default_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1] / "configs/VOC-COCO" / config))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0
    cfg.SOLVER.WARMUP_ITERS = 0
    trainer = Trainer(cfg, seed=0)
    batch = small_trainer_batch(dev, cfg)
    trainer.step(batch)
    state = trainer.state
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    momentum = copy.deepcopy(state.optimizer.state_dict())
    trainer.step(batch)
    first = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state.model.load_state_dict(params)
    state.optimizer.load_state_dict(momentum)
    state.step -= 1
    trainer.step(batch)
    differ = [n for n, p in state.model.named_parameters() if not torch.equal(p, first[n])]
    assert not differ, differ


def test_device_prefetch_and_to_host_on_the_card(dev):
    """Batches staged on the copy stream arrive intact on the consumer's
    stream; ``to_host``'s pinned copies equal ``.cpu()`` once its event has
    fired."""
    from types import SimpleNamespace

    import numpy as np

    from openset_rcnn_tpu_torch.data.loader import device_prefetch
    from openset_rcnn_tpu_torch.evaluation.testing import to_host
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    g = torch.Generator().manual_seed(10)
    host = [ImageBatch(torch.randint(0, 256, (4, 320, 480, 3), dtype=torch.uint8, generator=g),
                       torch.rand(4, 2, generator=g),
                       GroundTruth(torch.rand(4, 8, 4, generator=g), torch.randint(0, 9, (4, 8), generator=g),
                                   torch.rand(4, 8, generator=g) > 0.5)) for _ in range(5)]
    got = list(device_prefetch(((b, i) for i, b in enumerate(host)), dev))
    assert [m for _, m in got] == list(range(5))
    for (b, _), want in zip(got, host):
        assert b.images.is_cuda and torch.equal(b.images.cpu(), want.images)
        assert torch.equal(b.gt.valid.cpu(), want.gt.valid)
        out = torch.nn.functional.avg_pool2d(b.images.permute(0, 3, 1, 2).float(), 4)
        copy = to_host(SimpleNamespace(x=out, n=out.sum((1, 2, 3))), ("x", "n")).numpy()
        np.testing.assert_array_equal(copy["x"], out.cpu().numpy())
        np.testing.assert_array_equal(copy["n"], out.sum((1, 2, 3)).cpu().numpy())


def config_file(name, **tpu):
    from pathlib import Path

    from openset_rcnn_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1] / "configs/VOC-COCO" / name))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0
    for key, value in tpu.items():
        setattr(cfg.TPU, key, value)
    return cfg


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("config", ["openset_rcnn_SwinT_FPN_128k.yaml", "openset_rcnn_ViT_FPN_128k.yaml"])
def test_transformer_backbone_on_the_card_matches_the_cpu(dev, config, dtype, tol):
    """The Swin-T and ViT-B detectors' pyramids on the card against the same
    seeded model on the CPU, on 2 x 64 x 96: within ``tol`` of max(1,
    max|want|) (f32 without TF32; bf16 rounds after other f32 sums)."""
    from openset_rcnn_tpu_torch.device import entry_numerics
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, build_model

    cfg = config_file(config, DTYPE=dtype)
    spec = ModelSpec.from_cfg(cfg)
    cpu = build_model(spec, "cpu", seed=0)
    gpu = build_model(spec, dev, state_dict=cpu.state_dict())
    batch = small_trainer_batch(dev, cfg)
    with torch.no_grad(), entry_numerics():
        want = cpu.features(batch.images.cpu(), batch.image_hw.cpu())
        got = gpu.features(batch.images, batch.image_hw)
    assert set(got) == {"p2", "p3", "p4", "p5", "p6"}
    for k, w in want.items():
        assert got[k].dtype == w.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16), k
        err = float((got[k].cpu().double() - w.double()).abs().max())
        assert err <= tol * max(1.0, float(w.double().abs().max())), (k, err)


def test_remat_step_on_the_card_is_bitwise_the_plain_step(dev):
    """One Trainer.step with TPU.REMAT true from the seeded init gives the
    parameters of the same step without it, bit for bit."""
    from openset_rcnn_tpu_torch.engine.train_state import Trainer

    params = {}
    for remat in (False, True):
        cfg = config_file("openset_rcnn_R50_FPN_128k.yaml", REMAT=remat)
        cfg.SOLVER.WARMUP_ITERS = 0
        trainer = Trainer(cfg, seed=0)
        assert trainer.model.backbone.remat is remat
        trainer.step(small_trainer_batch(dev, cfg))
        params[remat] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    differ = [n for n, p in params[True].items() if not torch.equal(p, params[False][n])]
    assert not differ, differ


# ------------------------------------------------ the custom operators (K1, K4)


@pytest.mark.parametrize("ratio", [2, -1])  # the static grid, the adaptive one
def test_roi_align_operator_is_bitwise_the_direct_launch(dev, ratio):
    """``torch.ops.openset_rcnn.roi_align_fwd`` (what ``roi_align`` calls)
    gives the launch code's result bit for bit, counted once."""
    from openset_rcnn_tpu_torch.ops import roi_align as ops

    feats, boxes = roi_inputs(dev, 2, 301, 256, seed=11)
    levels = assign_levels(boxes)
    direct = ops._roi_align_cuda(feats, boxes, levels, list(STRIDES), 7, ratio)
    counts = roi_align.launches, roi_align.adaptive_launches
    got = torch.ops.openset_rcnn.roi_align_fwd(feats, boxes, levels, list(STRIDES), 7, ratio)
    torch.cuda.synchronize()
    assert torch.equal(got, direct)
    assert (roi_align.launches, roi_align.adaptive_launches) == (counts[0] + (ratio == 2), counts[1] + (ratio == -1))


def test_nms_operator_is_bitwise_the_direct_launch(dev):
    from openset_rcnn_tpu_torch.ops import nms as ops

    g = torch.Generator(device=dev).manual_seed(12)
    xy = torch.rand(8, 2000, 2, generator=g, device=dev) * 400
    boxes = torch.cat([xy, xy + 10 + torch.rand(8, 2000, 2, generator=g, device=dev) * 80], -1).contiguous()
    valid = torch.rand(8, 2000, generator=g, device=dev) > 0.2
    direct = ops._nms_keep_cuda(boxes, valid, 0.5)
    before = nms_keep.launches
    got = torch.ops.openset_rcnn.nms_keep(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, direct) and nms_keep.launches == before + 1


def test_fake_implementations_give_shapes_without_launching(dev):
    from torch._subclasses.fake_tensor import FakeTensorMode

    feats, boxes = roi_inputs(dev, 2, 33, 64, seed=13)
    levels = assign_levels(boxes)
    valid = torch.ones(2, 33, dtype=torch.bool, device=dev)
    counts = roi_align.launches, roi_align.adaptive_launches, nms_keep.launches
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = [mode.from_tensor(f) for f in feats]
        out = torch.ops.openset_rcnn.roi_align_fwd(fake, mode.from_tensor(boxes), mode.from_tensor(levels),
                                                   list(STRIDES), 7, -1)
        keep = torch.ops.openset_rcnn.nms_keep(mode.from_tensor(boxes), mode.from_tensor(valid), 0.5)
    assert (tuple(out.shape), out.dtype, out.device) == ((2, 33, 7, 7, 64), torch.float32, boxes.device)
    assert (tuple(keep.shape), keep.dtype, keep.device) == ((2, 33), torch.bool, boxes.device)
    assert (roi_align.launches, roi_align.adaptive_launches, nms_keep.launches) == counts


def test_exported_program_launches_both_kernels(dev, tmp_path):
    """``tools.export_serving`` on the card (single program), loaded back:
    one K1 and two K4 launches a call, the live ``Predictor``'s outputs
    within the JAX round trip's tolerances (integers and masks exactly)."""
    from openset_rcnn_tpu_torch.device import entry_numerics
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor
    from openset_rcnn_tpu_torch.tools import export_serving

    cfg = config_file("openset_rcnn_R50_FPN_128k_tpu.yaml", TEST_BUCKET=(128, 160))
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 200
    path = tmp_path / "config.yaml"
    path.write_text(cfg.dump())
    out = str(tmp_path / "serving.pt2")
    export_serving.main(["--config-file", str(path), "--batch", "2", "--out", out])
    program = export_serving.load(out)
    g = torch.Generator().manual_seed(14)
    images = (torch.tensor(cfg.MODEL.PIXEL_MEAN) + torch.rand(2, 128, 160, 3, generator=g) * 60 - 30).to(dev)
    image_hw = torch.tensor([[128.0, 160.0], [100.0, 150.0]], device=dev)
    before = roi_align.launches, nms_keep.launches
    with torch.inference_mode(), entry_numerics():
        boxes, scores, classes, valid, overflow = program(images, image_hw)
    torch.cuda.synchronize()
    assert (roi_align.launches, nms_keep.launches) == (before[0] + 1, before[1] + 2)
    live = Predictor(cfg, dev, seed=0)(images, image_hw)
    torch.testing.assert_close(boxes, live.boxes, rtol=1e-3, atol=1e-2)
    torch.testing.assert_close(scores, live.scores, rtol=1e-4, atol=2e-3)
    for got, want in ((classes, live.classes), (valid, live.valid), (overflow, live.known_overflow)):
        assert torch.equal(got, want)


def test_train_step_through_the_operator_is_bitwise_the_direct_launch(dev, monkeypatch):
    """One f32 Trainer.step with RoIAlign's forward through the operator
    gives the parameters of the same step with the launch code called
    directly, as before the operator existed."""
    from openset_rcnn_tpu_torch.engine.train_state import Trainer
    from openset_rcnn_tpu_torch.ops import roi_align as ops

    params = {}
    for route in ("operator", "direct"):
        if route == "direct":  # the wrapper calls the launch code in place of the operator
            monkeypatch.setattr(ops, "roi_align_op", ops._roi_align_cuda)
        cfg = config_file("openset_rcnn_R50_FPN_128k.yaml")
        cfg.SOLVER.WARMUP_ITERS = 0
        trainer = Trainer(cfg, seed=0)
        before = roi_align.launches
        trainer.step(small_trainer_batch(dev, cfg))
        assert roi_align.launches == before + 1
        params[route] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    differ = [n for n, p in params["operator"].items() if not torch.equal(p, params["direct"][n])]
    assert not differ, differ
