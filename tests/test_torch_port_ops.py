"""Ops of the PyTorch port against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function and its port
counterpart. On the CPU the port's kernel wrappers run their plain versions;
the CUDA kernels themselves are held against those on the GPU
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_rcnn_tpu.ops import anchors as jax_anchors
from openset_rcnn_tpu.ops import box_transforms as jax_tf
from openset_rcnn_tpu.ops import boxes as jax_boxes
from openset_rcnn_tpu.ops import nms as jax_nms
from openset_rcnn_tpu.ops import roi_align as jax_roi
from openset_rcnn_tpu.ops.pallas.nms_kernel import nms_keep_pallas
from openset_rcnn_tpu.ops.pallas.roi_align_kernel import WIN_X, WIN_Y, _geometry, roi_align_pallas_fwd
from openset_rcnn_tpu.ops.pallas.roi_align_v2 import roi_align_pallas_v2
from openset_rcnn_tpu_torch.ops import anchors as port_anchors
from openset_rcnn_tpu_torch.ops import box_transforms as port_tf
from openset_rcnn_tpu_torch.ops import boxes as port_boxes
from openset_rcnn_tpu_torch.ops import nms as port_nms
from openset_rcnn_tpu_torch.ops import roi_align as port_roi
from openset_rcnn_tpu_torch.ops.topk import stable_topk

STRIDES = (4, 8, 16, 32)
LEVEL_HW = [(64, 96), (32, 48), (16, 24), (8, 12)]  # a 256 x 384 canvas
IMG_H, IMG_W = 256, 384


def assert_close(got, want, tol):
    """|got - want| <= tol * max(1, max|want|): f32 tolerance scaled to magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def t(x):
    return torch.from_numpy(np.asarray(x))


def random_boxes(rng, shape, lo=0.0, hi=300.0, wmin=1.0, wmax=120.0):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(wmin, wmax, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# --------------------------------------------------------------- boxes


def test_boxes_match_jax(rng):
    b1 = random_boxes(rng, (2, 7))
    b2 = random_boxes(rng, (2, 5))
    b2[0, 0] = b2[0, 0, [0, 1, 0, 1]]  # empty box
    hw = np.asarray([[200.0, 250.0], [320.0, 180.0]], np.float32)
    assert_close(port_boxes.box_area(t(b1)), jax_boxes.box_area(b1), 1e-6)
    want = jax.vmap(jax_boxes.clip_boxes)(jnp.asarray(b1), jnp.asarray(hw))
    assert_close(port_boxes.clip_boxes(t(b1), t(hw)), want, 1e-6)
    np.testing.assert_array_equal(
        port_boxes.nonempty(t(b2), 3.0).numpy(), np.asarray(jax_boxes.nonempty(b2, 3.0))
    )
    want = jax.vmap(jax_boxes.pairwise_iou)(jnp.asarray(b1), jnp.asarray(b2))
    assert_close(port_boxes.pairwise_iou(t(b1), t(b2)), want, 1e-6)
    assert_close(port_boxes.elementwise_iou(t(b1[:, :5]), t(b2)), jax_boxes.elementwise_iou(b1[:, :5], b2), 1e-6)


def test_box_transforms_match_jax(rng):
    src = random_boxes(rng, (3, 40), wmin=4.0)
    tgt = random_boxes(rng, (3, 40), wmin=4.0)
    deltas = rng.randn(3, 40, 4).astype(np.float32)
    deltas[0, :5, 2:] = 50.0  # beyond SCALE_CLAMP
    for jt, pt in (
        (jax_tf.Box2BoxTransform((10.0, 10.0, 5.0, 5.0)), port_tf.Box2BoxTransform((10.0, 10.0, 5.0, 5.0))),
        (jax_tf.Box2BoxTransformLinear(True), port_tf.Box2BoxTransformLinear(True)),
    ):
        assert_close(pt.get_deltas(t(src), t(tgt)), jt.get_deltas(src, tgt), 1e-6)
        # negative ltrb deltas exercise the Linear transform's >= 0 clamp
        assert_close(pt.apply_deltas(t(deltas), t(src)), jt.apply_deltas(deltas, src), 1e-6)


def test_anchors_exact():
    args = ((832, 1344), (4, 8, 16, 32, 64), ((32,), (64,), (128,), (256,), (512,)), (0.5, 1.0, 2.0))
    for got, want in zip(port_anchors.fpn_anchors(*args), jax_anchors.fpn_anchors(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_stable_topk_keeps_lax_tie_order(rng):
    x = rng.randint(0, 5, (3, 200)).astype(np.float32)  # many ties
    x[0, ::3] = -np.inf
    for k in (1, 17, 200):
        v, i = stable_topk(t(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# ------------------------------------------------------------ RoIAlign


def roi_boxes(rng, B, R):
    """Boxes over all four levels, touching or crossing the image edge, tiny,
    and with aspect ratio above 4 (which the TPU kernel would bump a level)."""
    n = R // 6
    side = np.exp(rng.uniform(np.log(8.0), np.log(480.0), (B, R)))  # levels 2..5
    ar = rng.uniform(0.5, 2.0, (B, R))
    ar[:, :n] = rng.uniform(4.5, 8.0, (B, n))            # wide
    ar[:, n : 2 * n] = 1.0 / rng.uniform(4.5, 8.0, (B, n))  # tall
    w, h = side * np.sqrt(ar), side / np.sqrt(ar)
    cx = rng.uniform(0, IMG_W, (B, R))
    cy = rng.uniform(0, IMG_H, (B, R))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    boxes[:, 2 * n : 3 * n] = np.clip(boxes[:, 2 * n : 3 * n], 0, [IMG_W, IMG_H, IMG_W, IMG_H])
    tiny = boxes[:, 3 * n : 4 * n]
    tiny[..., 2:] = tiny[..., :2] + rng.uniform(0.05, 1.0, tiny[..., 2:].shape)
    boxes[:, 4 * n, :] = [0.0, 0.0, IMG_W, IMG_H]  # the whole canvas
    boxes[:, 4 * n + 1, :] = [10.0, 10.0, 10.0, 30.0]  # zero width
    return boxes.astype(np.float32)


def bf16_features(rng, B, C):
    """Unit-scale features rounded to bf16 once; both sides read the same bits."""
    port = [torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32)).to(torch.bfloat16) for h, w in LEVEL_HW]
    jax_side = [jnp.asarray(f.float().numpy()).astype(jnp.bfloat16) for f in port]
    return port, jax_side


def test_assign_levels_match_jax(rng):
    boxes = roi_boxes(rng, 2, 300)
    got = port_roi.assign_levels(t(boxes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_roi.assign_levels(jnp.asarray(boxes))))
    assert set(np.unique(got.numpy())) == {0, 1, 2, 3}


def test_roi_align_plain_matches_gather(rng):
    B, R, C = 2, 60, 32
    feats, jfeats = bf16_features(rng, B, C)
    boxes = roi_boxes(rng, B, R)
    want = jax_roi.multilevel_roi_align_batched(jfeats, jnp.asarray(boxes), STRIDES, impl="gather")
    levels = port_roi.assign_levels(t(boxes))
    # a chunk that does not divide B * R exercises the chunked loop's edge
    got = port_roi.roi_align_plain(feats, t(boxes), levels, STRIDES, chunk=16)
    assert got.dtype == torch.float32 and got.shape == (B, R, 7, 7, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(port_roi.roi_align(feats, t(boxes), levels, STRIDES).numpy(), got.numpy())


def test_roi_align_plain_matches_pallas_v2(rng):
    """Against the TPU kernel in interpret mode, on boxes below its
    level-bump bound (aspect < 3.6), where it computes the gather path."""
    B, R, C = 2, 16, 32
    feats, jfeats = bf16_features(rng, B, C)
    ar = rng.uniform(0.6, 1.8, (B, R))
    area = rng.uniform(10**2, 150**2, (B, R))
    w, h = np.sqrt(area * ar), np.sqrt(area / ar)
    cx, cy = rng.uniform(0, IMG_W, (B, R)), rng.uniform(0, IMG_H, (B, R))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    boxes = np.clip(boxes, 0, np.asarray([IMG_W, IMG_H, IMG_W, IMG_H], np.float32))
    want = roi_align_pallas_v2(jfeats, jnp.asarray(boxes), STRIDES, interpret=True)
    got = port_roi.roi_align(feats, t(boxes), port_roi.assign_levels(t(boxes)), STRIDES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


# ------------------------------------------------ K5: window-fit RoIAlign


def elongated_boxes(rng, B, R):
    """Inside the canvas, a quarter wide and a quarter tall (aspect 3.7 to
    9, beyond the window-fit bound of ~3.6), over all four levels."""
    n = R // 4
    side = np.exp(rng.uniform(np.log(8.0), np.log(480.0), (B, R)))
    ar = rng.uniform(0.6, 1.6, (B, R))
    ar[:, :n] = rng.uniform(3.7, 9.0, (B, n))
    ar[:, n : 2 * n] = 1.0 / rng.uniform(3.7, 9.0, (B, n))
    w, h = side * np.sqrt(ar), side / np.sqrt(ar)
    cx, cy = rng.uniform(0, IMG_W, (B, R)), rng.uniform(0, IMG_H, (B, R))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return np.clip(boxes, 0, [IMG_W, IMG_H, IMG_W, IMG_H]).astype(np.float32)


def test_assign_levels_window_fit_matches_the_kernels_rule(rng):
    """Exactly the level of ``roi_align_kernel._geometry`` (the rule of K1
    and K5 on the TPU), on random boxes of which the rule moves some up."""
    boxes = np.concatenate([elongated_boxes(rng, 2, 400), roi_boxes(rng, 2, 300)], 1)
    got = port_roi.assign_levels_window_fit(t(boxes), STRIDES)
    pad_hw = [(max(h, WIN_Y), (max(w, WIN_X) + 7) // 8 * 8) for h, w in LEVEL_HW]
    want = _geometry(LEVEL_HW, pad_hw, STRIDES, jnp.asarray(boxes.reshape(-1, 4)), 7, 2, 4)["lvl"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().reshape(-1), np.asarray(want))
    bumped = got != port_roi.assign_levels(t(boxes))
    assert 0 < int(bumped.sum()) and bool((got >= port_roi.assign_levels(t(boxes))).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_window_matches_pallas_fwd(rng, dtype):
    """K5's counterpart against ``roi_align_pallas_fwd`` in interpret mode.

    f32 features: at K5's own tolerance, atol 2e-5
    (tests/test_roi_align_pallas.py:29). bf16 features: the installed JAX
    cannot trace K5 on bf16 features (the kernel stores an f32 product into
    its bf16 scratch, roi_align_kernel.py:158), so the reference is K5 on
    f32 copies of the same bf16 values, rounded to bf16 once; the port
    computes in f32 and rounds once, so the two differ by at most one bf16
    step where their f32 values straddle a rounding boundary (rtol 2^-7)."""
    B, R, C = 2, 24, 32
    boxes = elongated_boxes(rng, B, R)
    assert bool((port_roi.assign_levels_window_fit(t(boxes), STRIDES) != port_roi.assign_levels(t(boxes))).any())
    feats32 = [rng.randn(B, h, w, C).astype(np.float32) for h, w in LEVEL_HW]
    if dtype == "float32":
        feats = [t(f) for f in feats32]
        want = np.asarray(roi_align_pallas_fwd([jnp.asarray(f) for f in feats32], jnp.asarray(boxes), STRIDES,
                                               interpret=True))
        atol, rtol = 2e-5, 0.0
    else:
        feats = [t(f).to(torch.bfloat16) for f in feats32]
        want = roi_align_pallas_fwd([jnp.asarray(f.float().numpy()) for f in feats], jnp.asarray(boxes), STRIDES,
                                    interpret=True)
        want = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
        atol, rtol = 1e-6, 2.0**-7
    got = port_roi.roi_align_window_plain(feats, t(boxes), STRIDES)
    assert got.dtype == feats[0].dtype and got.shape == (B, R, 7, 7, C)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(port_roi.roi_align_window(feats, t(boxes), STRIDES), got)
    # the gather levels give other values on the bumped boxes: the rule matters
    gather = port_roi.roi_align_plain(feats, t(boxes), port_roi.assign_levels(t(boxes)), STRIDES)
    assert float((gather - got.float()).abs().max()) > 0.1


# ----------------------------------------------------------------- NMS


def nms_inputs(rng, B, N):
    """Dense overlapping boxes with tied scores, ~20% invalid, and pairs whose
    IoU is exactly 0.5 (integer corners: the area ratios are exact)."""
    boxes = random_boxes(rng, (B, N), hi=120.0, wmin=10.0, wmax=60.0)
    scores = rng.randint(0, 12, (B, N)).astype(np.float32) / 12.0  # ties
    valid = rng.rand(B, N) > 0.2
    for b in range(B):
        for k in range(0, 12, 2):
            x, y = float(rng.randint(0, 100)), float(rng.randint(0, 100))
            boxes[b, k] = [x, y, x + 20, y + 20]       # area 400
            boxes[b, k + 1] = [x, y, x + 20, y + 10]   # inside, area 200: IoU 0.5
            scores[b, k], scores[b, k + 1] = 0.99, 0.98
            valid[b, k : k + 2] = True
    return boxes, scores, valid


@pytest.mark.parametrize("thresh", [0.5, 0.7])
def test_nms_mask_matches_jax(rng, thresh):
    boxes, scores, valid = nms_inputs(rng, 3, 150)
    res = port_nms.nms_mask(t(boxes), t(scores), t(valid), thresh)
    keep_count = 0
    for b in range(boxes.shape[0]):
        want = jax_nms.nms_mask(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), jnp.asarray(valid[b]),
                                thresh, use_pallas=False)
        np.testing.assert_array_equal(res.order[b].numpy(), np.asarray(want.order))
        np.testing.assert_array_equal(res.keep[b].numpy(), np.asarray(want.keep))
        keep_count += int(np.asarray(want.keep).sum())
    assert 0 < keep_count < valid.sum()


def test_nms_keep_matches_pallas_kernel(rng):
    boxes, scores, valid = nms_inputs(rng, 2, 200)
    order = np.argsort(-np.where(valid, scores, -np.inf), axis=1, kind="stable")
    sb = np.take_along_axis(boxes, order[..., None], 1)
    sv = np.take_along_axis(valid, order, 1)
    got = port_nms.nms_keep(t(sb), t(sv), 0.5)
    # the exact-0.5 pairs: the second box of each survives strict '>'
    for b in range(2):
        want = nms_keep_pallas(jnp.asarray(sb[b]), jnp.asarray(sv[b]), 0.5, interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert got.numpy()[sv].any() and not got.numpy()[~sv].any()


@pytest.mark.parametrize("N,case", [(1, "random"), (63, "random"), (64, "random"), (65, "random"),
                                    (130, "random"), (70, "all_invalid"), (70, "all_identical")])
def test_nms_keep_plain_matches_pallas_kernel_at_word_boundaries(rng, N, case):
    """The CUDA kernel's oracle against the TPU kernel in interpret mode
    across the kernel's 64-row mask words, with nothing valid and with every
    box the same."""
    boxes = random_boxes(rng, (2, N), hi=120.0, wmin=10.0, wmax=60.0)
    valid = rng.rand(2, N) > 0.2
    if case == "all_invalid":
        valid[:] = False
    elif case == "all_identical":
        boxes[:] = boxes[:, :1]
        valid[:] = True
    got = port_nms.nms_keep_plain(t(boxes), t(valid), 0.5)
    for b in range(2):
        want = nms_keep_pallas(jnp.asarray(boxes[b]), jnp.asarray(valid[b]), 0.5, interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    if case == "all_identical":
        assert got[:, 0].all() and not got[:, 1:].any()
    assert not got.numpy()[~valid].any()


def test_batched_nms_mask_matches_jax(rng):
    boxes, scores, valid = nms_inputs(rng, 2, 120)
    classes = rng.randint(0, 4, (2, 120)).astype(np.int32)
    res = port_nms.batched_nms_mask(t(boxes), t(scores), t(classes), t(valid), 0.5)
    for b in range(2):
        want = jax_nms.batched_nms_mask(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), jnp.asarray(classes[b]),
                                        jnp.asarray(valid[b]), 0.5)
        np.testing.assert_array_equal(res.order[b].numpy(), np.asarray(want.order))
        np.testing.assert_array_equal(res.keep[b].numpy(), np.asarray(want.keep))


def test_wrappers_run_only_on_cpu_or_cuda_tensors():
    """No silent fallback: a tensor on another device is refused."""
    boxes = torch.zeros((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port_nms.nms_keep(boxes, torch.zeros((1, 8), dtype=torch.bool, device="meta"), 0.5)
    feats = [torch.zeros((1, h, w, 8), dtype=torch.bfloat16, device="meta") for h, w in LEVEL_HW]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port_roi.roi_align(feats, boxes, torch.zeros((1, 8), dtype=torch.int32, device="meta"), STRIDES)
