"""Training ops of the PyTorch port against the JAX package, on the CPU.

Matcher, samplers, centerness targets, losses, the fused IoU+matcher (K3)
and the RoIAlign backward (K2) plain versions, RPN targets, ROI proposal
sampling and the optimizer. The samplers get the very uniforms JAX draws:
the tests rebuild the JAX key tree and hand the draws to the port. Floats
agree within a tolerance scaled to their magnitude; labels, indices and
masks exactly. The CUDA kernels themselves are held against the plain
versions on the GPU (tests/test_torch_port_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from openset_rcnn_tpu.config import get_default_cfg as jax_cfg
from openset_rcnn_tpu.engine import optimizer as jax_opt
from openset_rcnn_tpu.models import detector as jax_det
from openset_rcnn_tpu.models import roi_heads as jax_heads
from openset_rcnn_tpu.models import rpn as jax_rpn
from openset_rcnn_tpu.ops import losses as jax_losses
from openset_rcnn_tpu.ops import matcher as jax_matcher
from openset_rcnn_tpu.ops import roi_align as jax_roi
from openset_rcnn_tpu.ops import sampling as jax_sampling
from openset_rcnn_tpu.ops import targets as jax_targets
from openset_rcnn_tpu.ops.boxes import pairwise_iou as jax_pairwise_iou
from openset_rcnn_tpu.ops.pallas.iou_match_kernel import iou_match_pallas
from openset_rcnn_tpu.ops.pallas.roi_align_v2 import roi_align_pallas_v2_bwd
from openset_rcnn_tpu.structures import GroundTruth as JaxGT
from openset_rcnn_tpu.structures import Proposals as JaxProposals
from openset_rcnn_tpu_torch.config import get_default_cfg as port_cfg
from openset_rcnn_tpu_torch.engine import optimizer as port_opt
from openset_rcnn_tpu_torch.models import detector as port_det
from openset_rcnn_tpu_torch.models import roi_heads as port_heads
from openset_rcnn_tpu_torch.models import rpn as port_rpn
from openset_rcnn_tpu_torch.ops import iou_match as port_iou_match
from openset_rcnn_tpu_torch.ops import losses as port_losses
from openset_rcnn_tpu_torch.ops import matcher as port_matcher
from openset_rcnn_tpu_torch.ops import roi_align as port_roi
from openset_rcnn_tpu_torch.ops import sampling as port_sampling
from openset_rcnn_tpu_torch.ops import targets as port_targets
from openset_rcnn_tpu_torch.ops.boxes import pairwise_iou as port_pairwise_iou
from openset_rcnn_tpu_torch.structures import GroundTruth as PortGT
from openset_rcnn_tpu_torch.structures import Proposals as PortProposals

STRIDES = (4, 8, 16, 32)
LEVEL_HW = [(64, 96), (32, 48), (16, 24), (8, 12)]  # a 256 x 384 canvas
IMG_H, IMG_W = 256, 384


def assert_close(got, want, tol):
    """|got - want| <= tol * max(1, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def t(x):
    return torch.from_numpy(np.array(x))


def uniforms(key, n, count):
    """The draws of ``jax.random.split(key, count)``'s keys, (count, n)."""
    if count == 2:
        keys = jax.random.split(key)
    else:
        keys = jax.random.split(key, count)
    return np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])


def rpn_uniforms(rpn_key, B, R):
    """(B, 2, 2, R): per image split -> (k_reg, k_obj), each split -> (kp, kn)
    (models/rpn.py:127, ops/sampling.py:68)."""
    out = []
    for k in jax.random.split(rpn_key, B):
        k_reg, k_obj = jax.random.split(k)
        out.append([uniforms(k_reg, R, 2), uniforms(k_obj, R, 2)])
    return np.asarray(out, np.float32)


def roi_uniforms(roi_key, B, N):
    """(B, 3, N): per image split(., 3) -> (kp, kn, kt) (ops/sampling.py:104)."""
    return np.asarray([uniforms(k, N, 3) for k in jax.random.split(roi_key, B)], np.float32)


def integer_boxes(rng, shape, hi=80, wmax=40):
    """Integer corners: many IoUs tie exactly."""
    xy = rng.randint(0, hi, shape + (2,))
    wh = rng.randint(1, wmax, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def anchors_64x96():
    spec = port_det.ModelSpec.from_cfg(load_port_cfg())
    anchors, _ = port_det.compute_anchors(spec, (64, 96))
    return anchors


def load_port_cfg():
    cfg = port_cfg()
    cfg.OPENDET_BENCHMARK = True
    return cfg


def make_gt(rng, B, G):
    """Padded GT on a 64 x 96 canvas: integer corners, one image without
    valid GT, one zero-area GT, and a duplicate GT row."""
    boxes = integer_boxes(rng, (B, G), hi=60, wmax=36)
    boxes[0, 1] = [20.0, 20.0, 20.0, 30.0]  # zero area
    boxes[0, 2] = boxes[0, 3]               # duplicate: ties between GT rows
    valid = rng.rand(B, G) > 0.25
    valid[0, :4] = True
    valid[-1] = False                       # an image without GT
    classes = rng.randint(0, 81, (B, G)).astype(np.int32)
    classes[0, :3] = [3, 7, 25]             # known, known, unknown
    return boxes, classes, valid


# ------------------------------------------------------------- matcher


@pytest.mark.parametrize("rescue", [True, False])
def test_match_matches_jax(rng, rescue):
    G, N = 7, 300
    gt = integer_boxes(rng, (G,))
    cand = integer_boxes(rng, (N,))
    iou = np.asarray(jax_pairwise_iou(jnp.asarray(gt), jnp.asarray(cand)))
    for valid in (rng.rand(G) > 0.3, np.zeros(G, bool)):
        want = jax_matcher.match(jnp.asarray(iou), jnp.asarray(valid), [0.3, 0.7], [0, -1, 1], rescue)
        got = port_matcher.match(t(iou), t(valid), [0.3, 0.7], [0, -1, 1], rescue)
        np.testing.assert_array_equal(got.matched_idx.numpy(), np.asarray(want.matched_idx))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert rescue == (np.asarray(want.labels) == 1).any() or not valid.any()


# ------------------------------------------------------------ samplers


@pytest.mark.parametrize("n_pos", [3, 400])  # under and over the positive quota
def test_subsample_labels_matches_jax(rng, n_pos):
    N = 2000
    labels = np.full(N, -1, np.int32)
    idx = rng.permutation(N)
    labels[idx[:n_pos]] = 1
    labels[idx[n_pos : n_pos + 900]] = 0
    key = jax.random.PRNGKey(n_pos)
    u = uniforms(key, N, 2)
    u[:, ::7] = u[:, :1]  # tied draws: the lower index must win, as in lax.top_k
    # draws can only be fed to JAX through its key, so compare the port on
    # JAX's own draws, and on tied draws against a numpy rendering of JAX's rule
    want = jax_sampling.subsample_labels(jnp.asarray(labels), 256, 0.5, key)
    got = port_sampling.subsample_labels(t(labels), 256, 0.5, uniforms=t(uniforms(key, N, 2)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 1).sum() == min(n_pos, 128) and (got.numpy() == 0).sum() == 256 - min(n_pos, 128)
    tied = port_sampling.subsample_labels(t(labels), 256, 0.5, uniforms=t(u))
    for cls, quota, draws in ((1, min(n_pos, 128), u[0]), (0, 256 - min(n_pos, 128), u[1])):
        members = np.flatnonzero(labels == cls)
        order = members[np.lexsort((members, -draws[members]))][:quota]  # draw descending, index ascending
        np.testing.assert_array_equal(np.flatnonzero(tied.numpy() == cls), np.sort(order))


def test_sample_balanced_indices_matches_jax(rng):
    N = 700
    pos = rng.rand(N) < 0.1
    neg = ~pos & (rng.rand(N) < 0.5)
    for p, n in ((pos, neg), (pos & (np.arange(N) < 100), neg & (np.arange(N) < 200))):  # short of 512
        key = jax.random.PRNGKey(int(p.sum()))
        want = jax_sampling.sample_balanced_indices(jnp.asarray(p), jnp.asarray(n), 512, 0.25, key)
        # batched over a leading dim of 2 (the same image twice)
        u = t(np.stack([uniforms(key, N, 3)] * 2))
        got = port_sampling.sample_balanced_indices(t(np.stack([p, p])), t(np.stack([n, n])), 512, 0.25, uniforms=u)
        for field in ("indices", "is_pos", "valid"):
            for b in range(2):
                np.testing.assert_array_equal(getattr(got, field)[b].numpy(), np.asarray(getattr(want, field)))
    assert not np.asarray(want.valid).all()


def test_samplers_draw_from_a_generator(rng):
    labels = t(rng.randint(-1, 2, (2, 1000)).astype(np.int32))
    a = port_sampling.subsample_labels(labels, 256, 0.5, generator=torch.Generator().manual_seed(5))
    b = port_sampling.subsample_labels(labels, 256, 0.5, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and ((a == 1).sum(1) == 128).all() and ((a == 0).sum(1) == 128).all()


# -------------------------------------------------------- targets, losses


def test_centerness_targets_match_jax(rng):
    anchors = integer_boxes(rng, (3, 200))
    gt = integer_boxes(rng, (3, 200))
    labels = rng.randint(-1, 2, (3, 200)).astype(np.int32)
    got = port_targets.centerness_targets(t(anchors), t(gt), t(labels))
    want = jax_targets.centerness_targets(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(labels))
    assert_close(got, want, 1e-6)
    assert (np.asarray(want) > 0).any() and (np.asarray(want) == 0).any()


@pytest.mark.parametrize("loss_type", ["iou", "giou", "diou", "ciou"])
def test_box_losses_and_gradients_match_jax(rng, loss_type):
    pred = (integer_boxes(rng, (4, 60)) + rng.uniform(-3, 3, (4, 60, 4))).astype(np.float32)
    gt = integer_boxes(rng, (4, 60))
    fg = rng.rand(4, 60) > 0.4
    jfn = lambda p: jax_losses.dense_box_regression_loss(p, jnp.asarray(gt), jnp.asarray(fg), loss_type)
    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(pred))
    p = t(pred).requires_grad_(True)
    got = port_losses.dense_box_regression_loss(p, t(gt), t(fg), loss_type)
    got.backward()
    assert_close(got.detach(), want, 1e-6)
    assert_close(p.grad, want_grad, 1e-5)
    with pytest.raises(ValueError):
        port_losses.dense_box_regression_loss(p, t(gt), t(fg), "l2")


def test_smooth_l1_masked_sum_and_cross_entropy_match_jax(rng):
    a, b = rng.randn(5, 30).astype(np.float32), rng.randn(5, 30).astype(np.float32)
    for beta in (0.0, 0.5):
        assert_close(port_losses.smooth_l1(t(a), t(b), beta), jax_losses.smooth_l1(a, b, beta), 1e-6)
    mask = rng.rand(5) > 0.5
    assert_close(port_losses.masked_sum(t(a), t(mask)), jax_losses.masked_sum(a, mask), 1e-6)
    logits = (rng.randn(3, 40, 21) * 4).astype(np.float32)
    labels = rng.randint(0, 21, (3, 40)).astype(np.int32)
    valid = rng.rand(3, 40) > 0.3
    jfn = lambda lg: jax_losses.softmax_cross_entropy(lg, jnp.asarray(labels), jnp.asarray(valid))
    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(logits))
    lg = t(logits).requires_grad_(True)
    got = port_losses.softmax_cross_entropy(lg, t(labels), t(valid))
    got.backward()
    assert_close(got.detach(), want, 1e-6)
    assert_close(lg.grad, want_grad, 1e-6)


# ------------------------------------------------- K3: fused IoU + matcher


def test_iou_match_plain_matches_xla_and_pallas(rng):
    """Against rpn.py::_match_one_image (XLA) bitwise, and against the TPU
    kernel in interpret mode: indices, rescue flags and matched boxes
    exactly; max_iou bitwise (the kernel's max(union, 1e-12) only differs
    from the XLA form for unions in (0, 1e-12), which these inputs lack)."""
    anchors = anchors_64x96()
    anchors[::5] = np.round(anchors[::5])  # integer anchors against integer GT: exact IoU ties
    B, G = 4, 9
    gt, _, valid = make_gt(rng, B, G)
    got = port_iou_match.iou_match(t(anchors), t(gt), t(valid))
    assert got.matched_idx.dtype == torch.int32 and got.rescued.dtype == torch.bool
    kernel = [np.asarray(x) for x in iou_match_pallas(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid),
                                                      interpret=True)]
    for b in range(B):
        max_iou, idx, rescued = (np.asarray(x) for x in jax_rpn._match_one_image(
            jnp.asarray(anchors), jnp.asarray(gt[b]), jnp.asarray(valid[b])))
        np.testing.assert_array_equal(got.max_iou[b].numpy(), max_iou)
        np.testing.assert_array_equal(got.matched_idx[b].numpy(), idx)
        np.testing.assert_array_equal(got.rescued[b].numpy(), rescued)
        np.testing.assert_array_equal(got.matched_boxes[b].numpy(), gt[b][idx])
    for got_x, want_x in zip(got, kernel):
        np.testing.assert_array_equal(got_x.numpy(), want_x)
    # the inputs reach every case: no GT, ties, rescued anchors below 0.3
    assert (got.max_iou[-1] == -1).all() and not got.rescued[-1].any()
    m = got.max_iou[0]
    assert (got.rescued[0] & (m < 0.3)).any()
    assert len(torch.unique(m[m > 0])) < int((m > 0).sum())


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_iou_match_filter_premise(data):
    """The premise of K3's rescue pass (csrc/iou_match.cu), on the plain
    version: with best[g] a valid GT's best IoU over all anchors and t the
    smallest best[g] > 0, every rescued anchor has max_iou >= t, and every
    (a, g) with IoU == best[g] > 0 has best[g] <= max_iou[a]. Integer boxes
    (anchors included) make IoUs tie; duplicate GT rows, zero-area and
    invalid GT among them."""
    B = data.draw(st.integers(1, 3), label="B")
    G = data.draw(st.integers(1, 6), label="G")
    R = data.draw(st.integers(1, 24), label="R")
    def boxes(shape):
        xy = data.draw(hnp.arrays(np.int32, shape + (2,), elements=st.integers(0, 20)))
        wh = data.draw(hnp.arrays(np.int32, shape + (2,), elements=st.integers(0, 12)))  # 0: zero area
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)

    anchors, gt = boxes((R,)), boxes((B, G))
    if G > 1 and data.draw(st.booleans(), label="duplicate"):
        gt[:, -1] = gt[:, 0]
    valid = data.draw(hnp.arrays(np.bool_, (B, G)), label="valid")
    m = port_iou_match.iou_match_plain(t(anchors), t(gt), t(valid))
    iou = port_pairwise_iou(t(gt), t(anchors)[None])  # (B, G, R)
    best = torch.where(t(valid)[..., None], iou, torch.full_like(iou, -1.0)).amax(2)  # (B, G)
    positive = t(valid) & (best > 0)
    for b in range(B):
        if positive[b].any():
            floor = best[b][positive[b]].min()
            assert bool((m.max_iou[b][m.rescued[b]] >= floor).all())
        else:
            assert not m.rescued[b].any()
        ties = (iou[b] == best[b][:, None]) & positive[b][:, None]  # (G, R)
        assert bool((best[b][:, None].expand_as(ties)[ties] <= m.max_iou[b][None].expand_as(ties)[ties]).all())
        assert torch.equal(m.rescued[b], ties.any(0))


# ---------------------------------------------- K2: RoIAlign backward


def roi_boxes(rng, B, R, max_aspect=8.0):
    """Boxes over all four levels, across the image edge, tiny and with
    aspect ratio up to ``max_aspect``."""
    n = R // 5
    side = np.exp(rng.uniform(np.log(8.0), np.log(480.0), (B, R)))
    ar = rng.uniform(0.6, 1.6, (B, R))
    ar[:, :n] = rng.uniform(0.7 * max_aspect, max_aspect, (B, n))
    ar[:, n : 2 * n] = 1.0 / rng.uniform(0.7 * max_aspect, max_aspect, (B, n))
    w, h = side * np.sqrt(ar), side / np.sqrt(ar)
    cx, cy = rng.uniform(0, IMG_W, (B, R)), rng.uniform(0, IMG_H, (B, R))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    tiny = boxes[:, 2 * n : 3 * n]
    tiny[..., 2:] = tiny[..., :2] + rng.uniform(0.05, 1.0, tiny[..., 2:].shape)
    return boxes.astype(np.float32)


def gather_vjp(boxes, g, C):
    """jax.vjp of the gather path on f32 features: the exact f32 gradient."""
    feats = tuple(jnp.zeros((boxes.shape[0], h, w, C), jnp.float32) for h, w in LEVEL_HW)
    f = lambda fs: jax.vmap(lambda fl, bb: jax_roi._multilevel_roi_align_gather(list(fl), bb, STRIDES))(
        fs, jnp.asarray(boxes))
    _, vjp = jax.vjp(f, feats)
    return [np.asarray(x) for x in vjp(jnp.asarray(g))[0]]


def test_roi_align_bwd_plain_matches_gather_vjp(rng):
    B, R, C = 2, 50, 16
    boxes = roi_boxes(rng, B, R)
    g = rng.randn(B, R, 7, 7, C).astype(np.float32)
    levels = port_roi.assign_levels(t(boxes))
    assert set(np.unique(levels.numpy())) == {0, 1, 2, 3}
    # a chunk that does not divide B * R exercises the chunked loop's edge
    got = port_roi.roi_align_bwd_plain(t(g), t(boxes), levels, LEVEL_HW, STRIDES, chunk=16)
    for a, b in zip(got, gather_vjp(boxes, g, C)):
        assert a.dtype == torch.float32
        assert_close(a, b, 1e-5)
    # the wrapper takes the plain version for CPU tensors
    plain = port_roi.roi_align_bwd_plain(t(g), t(boxes), levels, LEVEL_HW, STRIDES)
    for a, b in zip(port_roi.roi_align_bwd(t(g), t(boxes), levels, LEVEL_HW, STRIDES), plain):
        assert torch.equal(a, b)


def test_roi_align_bwd_plain_matches_pallas_v2_bwd(rng):
    """Against the TPU kernel in interpret mode, on boxes below its
    level-bump bound (aspect < 3.6), at its own test's atol 1e-4."""
    B, R, C = 2, 12, 32
    boxes = roi_boxes(rng, B, R, max_aspect=3.0)
    boxes = np.clip(boxes, 0, np.asarray([IMG_W, IMG_H, IMG_W, IMG_H], np.float32))
    g = rng.randn(B, R, 7, 7, C).astype(np.float32)
    feats = [jnp.zeros((B, h, w, C), jnp.float32) for h, w in LEVEL_HW]
    want = roi_align_pallas_v2_bwd(feats, jnp.asarray(boxes), jnp.asarray(g), STRIDES, interpret=True)
    got = port_roi.roi_align_bwd_plain(t(g), t(boxes), port_roi.assign_levels(t(boxes)), LEVEL_HW, STRIDES)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def clustered_roi_boxes(rng, B, R, n_centres, jitter):
    """RoIs jittered around a few boxes per image, as the ROI sampler draws
    them around the GT: many RoIs add into the same cells."""
    wh = rng.uniform(16.0, 120.0, (B, n_centres, 2))
    xy = rng.uniform(0.0, 1.0, (B, n_centres, 2)) * (np.asarray([IMG_W, IMG_H]) - wh)
    centres = np.concatenate([xy, xy + wh], -1)
    base = np.take_along_axis(centres, rng.randint(0, n_centres, (B, R))[..., None], 1)
    side = np.concatenate([base[..., 2:] - base[..., :2]] * 2, -1)
    boxes = base + (rng.uniform(0.0, 1.0, (B, R, 4)) - 0.5) * jitter * side
    return np.clip(boxes, 0, np.asarray([IMG_W, IMG_H, IMG_W, IMG_H])).astype(np.float32)


@pytest.mark.parametrize("n_centres,jitter", [(3, 0.3), (1, 0.05)])  # 1: every RoI over one spot
def test_roi_align_bwd_plain_matches_pallas_v2_bwd_on_clustered_boxes(rng, n_centres, jitter):
    """The f32 accumulators against the TPU kernel in interpret mode where
    many RoIs overlap one cell (the CUDA kernel's atomics contend there),
    within 1e-5 * max(1, max|want|)."""
    B, R, C = 2, 24, 32
    boxes = clustered_roi_boxes(rng, B, R, n_centres, jitter)
    levels = port_roi.assign_levels(t(boxes))
    assert torch.equal(levels, port_roi.assign_levels_window_fit(t(boxes), STRIDES))  # the TPU kernel's levels
    g = rng.randn(B, R, 7, 7, C).astype(np.float32)
    feats = [jnp.zeros((B, h, w, C), jnp.float32) for h, w in LEVEL_HW]
    want = roi_align_pallas_v2_bwd(feats, jnp.asarray(boxes), jnp.asarray(g), STRIDES, interpret=True)
    got = port_roi.roi_align_bwd_plain(t(g), t(boxes), levels, LEVEL_HW, STRIDES)
    for a, b in zip(got, want):
        assert_close(a, b, 1e-5)
    # some point of the map lies inside at least a third of one image's RoIs on one level
    ctr = (boxes[..., :2] + boxes[..., 2:]) / 2
    inside = ((boxes[:, None, :, :2] <= ctr[:, :, None]) & (ctr[:, :, None] <= boxes[:, None, :, 2:])).all(-1)
    same_level = levels.numpy()[:, :, None] == levels.numpy()[:, None, :]
    assert (inside & same_level).sum(-1).max() >= R // 3


def test_roi_align_bwd_plain_f64_mode(rng):
    """The plain version's f64 mode (the oracle of the sum-order error of
    the f32 versions): the same sums in float64, within 1e-5 of JAX's f32
    gather VJP and of the f32 mode; other dtypes raise."""
    B, R, C = 2, 40, 8
    boxes = clustered_roi_boxes(rng, B, R, 2, 0.2)
    g = rng.randn(B, R, 7, 7, C).astype(np.float32)
    levels = port_roi.assign_levels(t(boxes))
    f64 = port_roi.roi_align_bwd_plain(t(g), t(boxes), levels, LEVEL_HW, STRIDES, acc_dtype=torch.float64)
    f32 = port_roi.roi_align_bwd_plain(t(g), t(boxes), levels, LEVEL_HW, STRIDES)
    assert all(a.dtype == torch.float64 for a in f64)
    for a, b, w in zip(f64, f32, gather_vjp(boxes, g, C)):
        assert_close(a, w, 1e-5)
        assert_close(b, a, 1e-5)
    with pytest.raises(ValueError, match="float64"):
        port_roi.roi_align_bwd_plain(t(g), t(boxes), levels, LEVEL_HW, STRIDES, acc_dtype=torch.float16)


@pytest.mark.parametrize("P,S", [(16, 2), (8, 4)])  # P * S = 32: the widest grid K2 f32 takes
def test_roi_align_bwd_plain_matches_gather_vjp_at_the_widest_grid(rng, P, S):
    """K2 f32's plain version against jax.vjp of the gather path at
    out_size * sampling_ratio = 32 (csrc/roi_align_bwd.cu F32Acc::kMaxPS),
    within 1e-5 * max(1, max|want|)."""
    B, R, C = 2, 10, 4
    boxes = roi_boxes(rng, B, R)
    g = rng.randn(B, R, P, P, C).astype(np.float32)
    levels = port_roi.assign_levels(t(boxes))
    got = port_roi.roi_align_bwd_plain(t(g), t(boxes), levels, LEVEL_HW, STRIDES, P, S)
    feats = tuple(jnp.zeros((B, h, w, C), jnp.float32) for h, w in LEVEL_HW)
    f = lambda fs: jax.vmap(lambda fl, bb: jax_roi._multilevel_roi_align_gather(list(fl), bb, STRIDES, P, S))(
        fs, jnp.asarray(boxes))
    _, vjp = jax.vjp(f, feats)
    for a, b in zip(got, vjp(jnp.asarray(g))[0]):
        assert_close(a, np.asarray(b), 1e-5)


def test_xla_backward_follows_the_forward_levels(rng):
    """Under impl="pallas" the port's bwd_impl="xla" gradient is its f32
    pallas gradient, bitwise: it goes to the levels the forward read. JAX's
    xla backward assigns canonical levels again, so on the box
    (20, 20, 260, 45) of a 256 x 512 pyramid, which the window-fit rule
    moves from p2 to p3, JAX's gradient reaches p2, which the forward never
    read, and the port's does not."""
    level_hw = [(64, 128), (32, 64), (16, 32), (8, 16)]  # a 256 x 512 pyramid
    B, C = 1, 8
    boxes = np.asarray([[[20.0, 20.0, 260.0, 45.0]]], np.float32)
    assert int(port_roi.assign_levels(t(boxes))) == 0
    assert int(port_roi.assign_levels_window_fit(t(boxes), STRIDES)) == 1
    fpn = {f"p{i + 2}": rng.randn(B, h, w, C).astype(np.float32) for i, (h, w) in enumerate(level_hw)}
    g = rng.randn(B, 1, 7, 7, C).astype(np.float32)

    def port_grads(bwd_impl):
        feats = {k: t(v).permute(0, 3, 1, 2).requires_grad_(True) for k, v in fpn.items()}
        port_heads.pool_features(feats, t(boxes), impl="pallas", bwd_impl=bwd_impl).backward(t(g))
        return [feats[k].grad.permute(0, 2, 3, 1) for k in sorted(fpn)]

    xla, pallas = port_grads("xla"), port_grads("pallas")
    for a, b in zip(xla, pallas):
        assert torch.equal(a, b)
    assert not xla[0].any() and float(xla[1].abs().sum()) > 0
    run = lambda fs: jax_heads.pool_features(fs, jnp.asarray(boxes), impl="pallas", bwd_impl="xla")
    _, vjp = jax.vjp(run, {k: jnp.asarray(v) for k, v in fpn.items()})
    (want,) = vjp(jnp.asarray(g))
    assert float(np.abs(np.asarray(want["p2"])).sum()) > 0  # JAX: gradient at a level the forward never read
    assert float(np.abs(np.asarray(want["p3"]) - xla[1].numpy()).max()) > 0


def test_roi_align_function_gradient_is_the_plain_backward(rng):
    """autograd through RoIAlignFunction: the features' gradient is the plain
    backward rounded to bf16; the boxes get none."""
    B, R, C = 2, 30, 8
    boxes = t(roi_boxes(rng, B, R))
    levels = port_roi.assign_levels(boxes)
    feats = [torch.randn(B, h, w, C, dtype=torch.float32).to(torch.bfloat16).requires_grad_(True)
             for h, w in LEVEL_HW]
    g = torch.from_numpy(rng.randn(B, R, 7, 7, C).astype(np.float32))
    out = port_roi.RoIAlignFunction.apply(boxes.requires_grad_(True), levels, STRIDES, 7, 2, torch.float32, *feats)
    assert torch.equal(out, port_roi.roi_align([f.detach() for f in feats], boxes.detach(), levels, STRIDES))
    out.backward(g)
    want = port_roi.roi_align_bwd_plain(g, boxes.detach(), levels, LEVEL_HW, STRIDES)
    for f, w in zip(feats, want):
        assert f.grad.dtype == torch.bfloat16
        assert torch.equal(f.grad, w.to(torch.bfloat16))
    assert boxes.grad is None


# ------------------------------ K2's bf16 accumulators; ROI_ALIGN_IMPL pallas
#
# Tolerances. bf16 accumulators: both sides sum each RoI's window gradient in
# f32 (in other orders) and round it into the cell once per RoI, so a cell
# whose f32 sum lies at a rounding boundary may take the neighbouring bf16
# value, and that step is carried into later rounds: within BF16_ACC_RTOL, 4
# bf16 steps (2^-5) of the cell, plus BF16_ACC_ATOL = 2^-12 of the largest
# cell (2 steps seen). Against JAX's f32 accumulators, the JAX suite's own
# band (rtol 3e-2, atol 5e-2, tests/test_roi_align_pallas.py:147-150).
BF16_ACC_RTOL, BF16_ACC_ATOL = 2.0**-5, 2.0**-12


def assert_bf16_acc_close(got, want):
    scale = max(1.0, max(float(np.abs(np.asarray(w, np.float32)).max()) for w in want))
    for lvl, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a.float()), np.asarray(w, np.float32), rtol=BF16_ACC_RTOL,
                                   atol=BF16_ACC_ATOL * scale, err_msg=f"level {lvl}")


def test_roi_align_bwd_plain_bf16_matches_pallas_v2_bwd(rng):
    """The pallas_bf16 mode: bf16 accumulators against
    ``roi_align_pallas_v2_bwd(acc_dtype=bfloat16)`` in interpret mode, with
    boxes that the window-fit rule moves up a level (the TPU kernel's levels)."""
    B, R, C = 2, 16, 32
    boxes = np.clip(roi_boxes(rng, B, R), 0, np.asarray([IMG_W, IMG_H, IMG_W, IMG_H], np.float32))
    levels = port_roi.assign_levels_window_fit(t(boxes), STRIDES)
    assert bool((levels != port_roi.assign_levels(t(boxes))).any())
    g = rng.randn(B, R, 7, 7, C).astype(np.float32)
    feats = [jnp.zeros((B, h, w, C), jnp.float32) for h, w in LEVEL_HW]
    want = roi_align_pallas_v2_bwd(feats, jnp.asarray(boxes), jnp.asarray(g), STRIDES, interpret=True,
                                   acc_dtype=jnp.bfloat16)
    want32 = roi_align_pallas_v2_bwd(feats, jnp.asarray(boxes), jnp.asarray(g), STRIDES, interpret=True)
    got = port_roi.roi_align_bwd_plain(t(g), t(boxes), levels, LEVEL_HW, STRIDES, acc_dtype=torch.bfloat16)
    assert all(a.dtype == torch.bfloat16 for a in got)
    assert_bf16_acc_close(got, want)
    for a, w in zip(got, want32):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w), rtol=3e-2, atol=5e-2)
    # the wrapper takes the plain version for CPU tensors
    for a, b in zip(port_roi.roi_align_bwd_bf16(t(g), t(boxes), levels, LEVEL_HW, STRIDES), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bwd_impl", ["pallas", "pallas_bf16"])
def test_pool_features_pallas_impl_matches_jax(rng, bwd_impl):
    """TPU.ROI_ALIGN_IMPL pallas: window-fit levels for K1 and K2. Forward
    and backward against JAX's ``pool_features(impl="pallas")`` (both v2
    kernels in interpret mode) on boxes the rule moves up a level. Forward at
    the kernel's tolerance; the feature gradients are accumulators rounded
    to bf16 on both sides: f32 accumulators within one bf16 step (rtol 2^-7,
    plus 1e-5 scaled), bf16 accumulators as above."""
    B, R, C = 2, 16, 16
    boxes = np.clip(roi_boxes(rng, B, R), 0, np.asarray([IMG_W, IMG_H, IMG_W, IMG_H], np.float32))
    assert bool((port_roi.assign_levels_window_fit(t(boxes), STRIDES) != port_roi.assign_levels(t(boxes))).any())
    fpn = {f"p{i + 2}": rng.randn(B, h, w, C).astype(np.float32) for i, (h, w) in enumerate(LEVEL_HW)}
    g = rng.randn(B, R, 7, 7, C).astype(np.float32)
    run = lambda fs: jax_heads.pool_features(fs, jnp.asarray(boxes), impl="pallas", bwd_impl=bwd_impl)
    want, vjp = jax.vjp(run, {k: jnp.asarray(v) for k, v in fpn.items()})
    (want_grads,) = vjp(jnp.asarray(g))

    feats = {k: t(v).permute(0, 3, 1, 2).requires_grad_(True) for k, v in fpn.items()}
    got = port_heads.pool_features(feats, t(boxes), impl="pallas", bwd_impl=bwd_impl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    got.backward(t(g))
    grads = [feats[k].grad.permute(0, 2, 3, 1) for k in sorted(fpn)]
    wants = [want_grads[k] for k in sorted(fpn)]
    if bwd_impl == "pallas_bf16":
        assert_bf16_acc_close(grads, wants)
    else:
        scale = max(1.0, max(float(np.abs(np.asarray(w)).max()) for w in wants))
        for a, w in zip(grads, wants):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2.0**-7, atol=1e-5 * scale)
    # the fault this repairs: gather levels pool the bumped boxes elsewhere
    gather = port_heads.pool_features({k: v.detach() for k, v in feats.items()}, t(boxes), impl="gather")
    assert float((gather - got.detach()).abs().max()) > 0.1


# --------------------------------------------- RPN targets, ROI sampling


def test_rpn_targets_match_jax(rng):
    anchors = anchors_64x96()
    anchors[::5] = np.round(anchors[::5])
    B, G = 4, 9
    gt, classes, valid = make_gt(rng, B, G)
    key = jax.random.PRNGKey(3)
    want = jax_rpn.rpn_targets(jnp.asarray(anchors), JaxGT(jnp.asarray(gt), jnp.asarray(classes), jnp.asarray(valid)),
                               key, use_pallas=False)
    got = port_rpn.rpn_targets(t(anchors), PortGT(t(gt), t(classes), t(valid)),
                               uniforms=t(rpn_uniforms(key, B, len(anchors))))
    for field in ("reg_labels", "obj_labels"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    np.testing.assert_array_equal(got.matched_boxes.numpy(), np.asarray(want.matched_boxes))
    assert_close(got.gt_centerness, want.gt_centerness, 1e-6)
    reg = got.reg_labels.numpy()
    assert (reg[:-1] == 1).sum(1).min() > 0
    assert (reg[-1] == 1).sum() == 0 and (reg[-1] == 0).sum() == 256  # no GT: 256 negatives
    assert ((reg == 0).sum(1) + (reg == 1).sum(1) == 256).all()


def test_label_and_sample_proposals_match_jax(rng):
    B, P, G = 3, 600, 9
    gt, classes, valid = make_gt(rng, B, G)
    # proposals near the GT so the foreground is not empty
    near = gt[:, rng.randint(0, G, P)] + rng.uniform(-6, 6, (B, P, 4)).astype(np.float32)
    boxes = np.where(rng.rand(B, P, 1) < 0.5, near, integer_boxes(rng, (B, P), hi=60)).astype(np.float32)
    scores = rng.uniform(0, 1, (B, P)).astype(np.float32)
    pvalid = rng.rand(B, P) > 0.1
    key = jax.random.PRNGKey(4)
    want = jax_heads.label_and_sample_proposals(
        JaxProposals(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(pvalid)),
        JaxGT(jnp.asarray(gt), jnp.asarray(classes), jnp.asarray(valid)), key, num_samples=512, num_classes=81)
    got = port_heads.label_and_sample_proposals(
        PortProposals(t(boxes), t(scores), t(pvalid)), PortGT(t(gt), t(classes), t(valid)),
        num_samples=512, num_classes=81, uniforms=t(roi_uniforms(key, B, P + G)))
    for field in ("gt_classes", "is_fg", "valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    for field in ("boxes", "scores", "gt_boxes", "ious"):
        assert_close(getattr(got, field), getattr(want, field), 1e-6)
    fg = got.is_fg.numpy()
    assert fg[0].sum() > 0 and fg[-1].sum() == 0 and (~got.valid.numpy()).sum() == 0


# ------------------------------------------------------------ model spec


def test_spec_id_map_matches_jax_and_unported_options_raise():
    cfg = load_port_cfg()
    spec = port_det.ModelSpec.from_cfg(cfg)
    want = jax_det.opendet_id_map(spec.num_classes, spec.num_known_classes)
    assert spec.id_map == tuple(int(x) for x in want) and spec.freeze_at == 2
    cfg.TPU.ROI_ALIGN_BWD = "pallas_bf16"  # ported: bf16 accumulators
    assert port_det.OpensetRCNN(port_det.ModelSpec.from_cfg(cfg)).spec.roi_align_bwd == "pallas_bf16"
    cfg.TPU.ROI_SAMPLING_RATIO = -1
    with pytest.raises(NotImplementedError, match="adaptive"):
        port_det.OpensetRCNN(port_det.ModelSpec.from_cfg(cfg))
    # ported: OPENDET_BENCHMARK false takes a known-id map (GraspNet's, from
    # the catalog, is held against JAX in test_torch_port_eval_path)
    cfg.OPENDET_BENCHMARK = False
    known = jax_det.known_ids_id_map(81, [3, 7, 11])
    assert port_det.ModelSpec.from_cfg(cfg, id_map=known).id_map == tuple(known)
    assert port_det.known_ids_id_map(81, [3, 7, 11]) == list(known)


# ------------------------------------------------------------ optimizer


def test_trainable_mask_matches_jax():
    jcfg = jax_cfg()
    jcfg.merge_from_file("configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml")
    spec = jax_det.ModelSpec.from_cfg(jcfg, jax_det.opendet_id_map(81, 20))
    module = jax_det.OpensetRCNNModule(spec=spec)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3))))["params"]
    model = port_det.OpensetRCNN(port_det.ModelSpec.from_cfg(load_port_cfg()))
    names = [n for n, _ in model.named_parameters()]
    for freeze_at in (0, 1, 2, 3):
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jax_opt.trainable_mask(shapes, freeze_at))[0]:
            keys = [p.key for p in path]
            want[".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else keys[-1]])] = bool(leaf)
        got = port_opt.trainable_mask(names, freeze_at)
        assert got == {n: want[n] for n in names}
        # every JAX leaf the port has no parameter for is a FrozenBN buffer, frozen in JAX too
        assert not any(v for k, v in want.items() if k not in got)


class TinyModel(torch.nn.Module):
    """Parameters named like the detector's: a frozen stem, a trainable block
    and a head."""

    def __init__(self, shapes):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.stem_conv = torch.nn.Module()
        self.backbone.res3_block0 = torch.nn.Module()
        self.box_head = torch.nn.Module()
        for (mod, name), shape in shapes.items():
            setattr(getattr(self.backbone, mod, None) or getattr(self, mod), name,
                    torch.nn.Parameter(torch.zeros(shape)))


@pytest.mark.parametrize("clip", [None, "value", "norm"])
def test_sgd_matches_optax(rng, clip):
    """3 steps across the warm-up's end (WARMUP_ITERS 2) and a decay step
    (STEPS (2,)), with momentum and weight decay."""
    def cfg_of(get_default_cfg):
        cfg = get_default_cfg()
        cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_ITERS, cfg.SOLVER.STEPS = 0.05, 2, (2,)
        cfg.SOLVER.CLIP_GRADIENTS.ENABLED = clip is not None
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = clip or "value"
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.5 if clip == "value" else 2.0
        return cfg

    jparams = {
        "backbone": {"stem_conv": {"kernel": rng.randn(3, 4).astype(np.float32)},
                     "res3_block0": {"kernel": rng.randn(5, 2).astype(np.float32)}},
        "box_head": {"kernel": rng.randn(6).astype(np.float32), "bias": rng.randn(2).astype(np.float32)},
    }
    tx, sched = jax_opt.build_optimizer(cfg_of(jax_cfg), jparams)
    model = TinyModel({("stem_conv", "weight"): (3, 4), ("res3_block0", "weight"): (5, 2),
                       ("box_head", "weight"): (6,), ("box_head", "bias"): (2,)})
    leaves = {"backbone.stem_conv.weight": ("backbone", "stem_conv", "kernel"),
              "backbone.res3_block0.weight": ("backbone", "res3_block0", "kernel"),
              "box_head.weight": ("box_head", "kernel"), "box_head.bias": ("box_head", "bias")}

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(t(leaf(jparams, leaves[name])))
    opt, schedule, trainable = port_opt.build_optimizer(cfg_of(port_cfg), model)
    assert len(trainable) == 3 and not model.backbone.stem_conv.weight.requires_grad
    clip_args = (clip, cfg_of(port_cfg).SOLVER.CLIP_GRADIENTS.CLIP_VALUE) if clip else None
    params = jax.tree.map(jnp.asarray, jparams)
    state = tx.init(params)
    for step in range(3):
        grads = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32) * 2, jparams)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        assert schedule(step) == float(sched(step))
        for name, p in model.named_parameters():
            p.grad = t(leaf(grads, leaves[name])) if p.requires_grad else None
        if clip_args:
            port_opt.clip_gradients(trainable, *clip_args)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
        for name, p in model.named_parameters():
            want = np.asarray(leaf(params, leaves[name]))
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    assert schedule(0) < schedule(1) < 0.05 and schedule(2) == pytest.approx(0.005)


def test_production_schedule_matches_jax():
    """configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml: batch 16, lr 0.02,
    warm-up over 100 steps, decays at 21k and 29k; the port's learning rate
    of every step equals JAX's, and the frozen stem stays out of the update."""
    def cfg_of(get_default_cfg):
        cfg = get_default_cfg()
        cfg.merge_from_file("configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml")
        return cfg

    cfg = cfg_of(port_cfg)
    assert (cfg.SOLVER.IMS_PER_BATCH, cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_ITERS) == (16, 0.02, 100)
    assert tuple(cfg.SOLVER.STEPS) == (21000, 29000)
    jparams = {"backbone": {"stem_conv": {"kernel": np.zeros((3, 4), np.float32)}},
               "box_head": {"kernel": np.zeros((6,), np.float32)}}
    _, sched = jax_opt.build_optimizer(cfg_of(jax_cfg), jparams)
    model = TinyModel({("stem_conv", "weight"): (3, 4), ("box_head", "weight"): (6,)})
    _, schedule, trainable = port_opt.build_optimizer(cfg, model)
    assert len(trainable) == 1 and not model.backbone.stem_conv.weight.requires_grad
    for step in (0, 1, 50, 99, 100, 101, 20999, 21000, 28999, 29000, 31999):
        assert schedule(step) == float(sched(step)), step
    assert schedule(100) == pytest.approx(0.02) and schedule(21000) == pytest.approx(0.002)
    assert schedule(29000) == pytest.approx(0.0002) and schedule(0) < schedule(50) < schedule(100)
