"""CUDA kernels of the PyTorch port against their plain PyTorch versions.

These need an NVIDIA GPU and skip without one. On a machine with the card
(which need not have JAX), run them with:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

The plain versions themselves are held against the JAX package on the CPU
(tests/test_torch_port_ops.py, tests/test_torch_port_train_ops.py).
"""
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
BWD_TOL = 1e-5  # RoIAlign backward, scaled by max(1, max|want|): atomics reorder the f32 sums
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


@pytest.mark.parametrize("N", [1, 33, 1000, 2000, 3000])  # 3000: above 48 KB of shared memory
@pytest.mark.parametrize("thresh", [0.5, 0.7])
def test_nms_kernel_matches_plain(dev, N, thresh):
    boxes, valid = nms_inputs(dev, 4, N, seed=N)
    before = nms_keep.launches
    got = nms_keep(boxes, valid, thresh)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    assert torch.equal(got, nms_keep_plain(boxes, valid, thresh))
    assert not got[~valid].any()


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


@pytest.mark.parametrize("C", [256, 200, 32])
def test_roi_align_bwd_kernel_matches_plain(dev, C):
    feats, boxes, levels, cot = bwd_inputs(dev, 3, 301, C, seed=C)
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    before = roi_align_bwd.launches
    got = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES)
    torch.cuda.synchronize()
    assert roi_align_bwd.launches == before + 1
    assert all(a.dtype == torch.float32 and a.shape == (3, h, w, C) for a, (h, w) in zip(got, level_hw))
    assert_bwd_close(got, roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES))


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


def test_roi_align_bwd_bf16_kernel_edges_tiles_and_levels(dev):
    """RoIs clamped at every map edge (partly or wholly outside the image),
    RoIs spanning many tiles, on every level, on maps whose sides are not
    multiples of the tile."""
    B, R, C = 2, 256, 32
    H, W = 200, 328  # P2 50 x 82: ragged against 8 x 16 tiles
    g = torch.Generator(device=dev).manual_seed(14)
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
    boxes = boxes.contiguous()
    levels = torch.randint(0, 4, (B, R), generator=g, device=dev, dtype=torch.int32)  # every level
    cot = torch.randn(B, R, 7, 7, C, generator=g, device=dev)
    level_hw = [(-(-H // s), -(-W // s)) for s in STRIDES]
    got = roi_align_bwd_bf16(cot, boxes, levels, level_hw, STRIDES)
    torch.cuda.synchronize()
    assert_bf16_acc_close(got, roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, acc_dtype=torch.bfloat16))
