"""CUDA kernels of the PyTorch port against their plain PyTorch versions.

These need an NVIDIA GPU and skip without one. On a machine with the card
(which need not have JAX), run them with:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

The plain versions themselves are held against the JAX package on the CPU
(tests/test_torch_port_ops.py).
"""
import pytest
import torch

from openset_rcnn_tpu_torch.ops.nms import nms_keep, nms_keep_plain
from openset_rcnn_tpu_torch.ops.roi_align import assign_levels, roi_align, roi_align_plain

pytestmark = pytest.mark.cuda
STRIDES = (4, 8, 16, 32)


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


@pytest.mark.parametrize("C", [256, 200, 32])
def test_roi_align_kernel_matches_plain(dev, C):
    feats, boxes = roi_inputs(dev, 3, 301, C, seed=C)
    levels = assign_levels(boxes)
    before = roi_align.launches
    got = roi_align(feats, boxes, levels, STRIDES)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 1
    want = roi_align_plain(feats, boxes, levels, STRIDES)
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
