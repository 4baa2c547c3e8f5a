"""The adaptive RoIAlign grid (``TPU.ROI_SAMPLING_RATIO -1``, both
``*_parity.yaml`` configs) of the PyTorch port against the JAX package, on
the CPU.

The plain forward against JAX's gather path
(``_multilevel_roi_align_gather(sampling_ratio=-1)``) within atol 2e-5 +
rtol 1e-5; the plain backward's f32 and f64 modes against ``jax.vjp`` of it
on f32 features within rtol 1e-5 + atol 1e-4, its bf16 mode within the
bf16 limit of the card's checks; ``pool_features``' override of
``ROI_ALIGN_IMPL`` and ``ROI_ALIGN_BWD``; one full R50-FPN training step of
``configs/VOC-COCO/openset_rcnn_R50_FPN_128k_parity.yaml`` against
``jax.value_and_grad`` at the tolerances of ``test_torch_port_train_step``
(its 2 x 64 x 96 canvas, 128 RoIs an image; boxes that small take 1-4
samples a bin axis, the tests above the rest up to the clip at 8).
The CUDA kernels' adaptive modes are held against the plain versions on the
card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_rcnn_tpu.models import roi_heads as jax_heads
from openset_rcnn_tpu.ops import roi_align as jax_roi
from openset_rcnn_tpu_torch.models import roi_heads as port_heads
from openset_rcnn_tpu_torch.ops import roi_align as port_roi
from tests import test_torch_port_train_step as train_step
from tests.port_threads import share_cores  # noqa: F401 (autouse)

STRIDES = (4, 8, 16, 32)
LEVEL_HW = [(64, 96), (32, 48), (16, 24), (8, 12)]  # a 256 x 384 canvas
IMG_H, IMG_W = 256, 384
ATOL, RTOL = 2e-5, 1e-5          # forward, elementwise
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4  # f32 backward against jax.vjp
BF16_ACC_RTOL, BF16_ACC_ATOL = 2.0**-5, 2.0**-7  # bf16 accumulators: 4 bf16 steps + 2^-7 of the largest cell
PARITY = Path(__file__).resolve().parents[1] / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k_parity.yaml"


def t(x):
    return torch.from_numpy(np.array(x))


def adaptive_boxes(rng, B, R):
    """Boxes whose adaptive counts take 1 (tiny boxes), 2-7 and the clip at
    8 (elongated boxes), some across the image edge (clipped samples)."""
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
    return boxes.astype(np.float32)


def counts(boxes):
    """(B, R, 2) adaptive samples per bin axis (y, x) at the gather levels."""
    lvl = port_roi.assign_levels(t(boxes)).numpy()
    scale = 1.0 / np.asarray(STRIDES, np.float32)[lvl]
    ext = np.stack([boxes[..., 3] - boxes[..., 1], boxes[..., 2] - boxes[..., 0]], -1) * scale[..., None]
    return np.clip(np.ceil(ext / np.float32(7.0)), 1, 8)


def jax_gather(feats, boxes):
    return jax.vmap(lambda fl, bb: jax_roi._multilevel_roi_align_gather(list(fl), bb, STRIDES, 7, -1))(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(boxes))


@pytest.fixture
def boxes(rng):
    b = adaptive_boxes(rng, 2, 60)
    n = counts(b)
    assert n.min() == 1 and n.max() == 8 and len(np.unique(n)) >= 6  # n = 1, the clip at 8, and between
    outside = (b[..., :2] < 0).any(-1) | (b[..., 2] > IMG_W) | (b[..., 3] > IMG_H)
    assert outside.any()  # samples beyond the map: clipped, still counted
    return b


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_roi_align_plain_adaptive_matches_gather(rng, boxes, dtype):
    C = 8
    feats = [rng.randn(2, h, w, C).astype(np.float32) for h, w in LEVEL_HW]
    if dtype == "bfloat16":  # the pooling dtype of pool_features
        feats = [np.asarray(jnp.asarray(f, jnp.bfloat16).astype(jnp.float32)) for f in feats]
    want = np.asarray(jax_gather(feats, boxes))
    pf = [t(f).to(torch.bfloat16) if dtype == "bfloat16" else t(f) for f in feats]
    levels = port_roi.assign_levels(t(boxes))
    # a chunk that does not divide B * R exercises the chunked loop's edge
    got = port_roi.roi_align_plain(pf, t(boxes), levels, STRIDES, 7, -1, chunk=17 * 16)
    assert got.dtype == torch.float32 and got.shape == (2, 60, 7, 7, C)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(port_roi.roi_align(pf, t(boxes), levels, STRIDES, 7, -1), got)
    # the static grid pools these boxes otherwise
    assert float((port_roi.roi_align_plain(pf, t(boxes), levels, STRIDES) - got).abs().max()) > 1e-3


@pytest.mark.parametrize("acc", ["float32", "float64", "bfloat16"])
def test_roi_align_bwd_plain_adaptive_matches_gather_vjp(rng, boxes, acc):
    B, R, C = 2, boxes.shape[1], 8
    g = rng.randn(B, R, 7, 7, C).astype(np.float32)
    zeros = tuple(jnp.zeros((B, h, w, C), jnp.float32) for h, w in LEVEL_HW)
    _, vjp = jax.vjp(lambda fs: jax_gather(fs, boxes), zeros)
    wants = [np.asarray(w) for w in vjp(jnp.asarray(g))[0]]
    levels = port_roi.assign_levels(t(boxes))
    got = port_roi.roi_align_bwd_plain(t(g), t(boxes), levels, LEVEL_HW, STRIDES, 7, -1,
                                       acc_dtype=getattr(torch, acc))
    assert all(a.dtype == getattr(torch, acc) for a in got)
    scale = max(float(np.abs(w).max()) for w in wants)
    for a, w in zip(got, wants):
        if acc == "bfloat16":
            np.testing.assert_allclose(a.float().numpy(), w, rtol=BF16_ACC_RTOL, atol=BF16_ACC_ATOL * scale)
        else:
            np.testing.assert_allclose(a.double().numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if acc == "float32":  # the wrapper takes the plain version for CPU tensors
        for a, b in zip(port_roi.roi_align_bwd(t(g), t(boxes), levels, LEVEL_HW, STRIDES, 7, -1), got):
            assert torch.equal(a, b)


def test_pool_features_adaptive_overrides_impl_and_bwd_impl(rng, boxes):
    """Under ``sampling_ratio=-1`` pool_features pools at the gather levels
    whatever ``impl`` says and sums the backward in f32 accumulators
    whatever ``bwd_impl`` says, as JAX's ``multilevel_roi_align_batched``
    (``openset_rcnn_tpu/ops/roi_align.py:387-388``): the same forward and
    gradient as ``impl="gather", bwd_impl="pallas"``, bitwise. JAX's
    ``pool_features`` overrides ``impl`` alike (bitwise its gather pooling),
    and the port's forward is its gather path on the same bf16 maps, held
    here in f32 (on bf16 arrays XLA's CPU gather path strays from that by up
    to 2.4e-5 on one value in 47,040 of these boxes)."""
    boxes = np.clip(boxes, 0, np.asarray([IMG_W, IMG_H, IMG_W, IMG_H], np.float32))
    assert bool((port_roi.assign_levels_window_fit(t(boxes), STRIDES) != port_roi.assign_levels(t(boxes))).any())
    B, R, C = 2, boxes.shape[1], 8
    fpn = {f"p{i + 2}": rng.randn(B, h, w, C).astype(np.float32) for i, (h, w) in enumerate(LEVEL_HW)}
    g = t(rng.randn(B, R, 7, 7, C).astype(np.float32))

    def port(impl, bwd_impl):
        feats = {k: t(v).permute(0, 3, 1, 2).requires_grad_(True) for k, v in fpn.items()}
        out = port_heads.pool_features(feats, t(boxes), sampling_ratio=-1, impl=impl, bwd_impl=bwd_impl)
        out.backward(g)
        return out.detach(), [feats[k].grad for k in sorted(fpn)]

    got, got_grads = port("pallas", "pallas_bf16")
    want, want_grads = port("gather", "pallas")
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_grads, want_grads))
    # the gradient is the f32 plain backward rounded to bf16 once
    levels = port_roi.assign_levels(t(boxes))
    f32 = port_roi.roi_align_bwd_plain(g, t(boxes), levels, LEVEL_HW, STRIDES, 7, -1)
    for a, b in zip(got_grads, f32):
        assert torch.equal(a.permute(0, 2, 3, 1), b.to(torch.bfloat16).float())
    jfpn = {k: jnp.asarray(v) for k, v in fpn.items()}
    run = lambda impl, bwd: np.asarray(jax_heads.pool_features(jfpn, jnp.asarray(boxes), sampling_ratio=-1,
                                                               impl=impl, bwd_impl=bwd))
    np.testing.assert_array_equal(run("pallas", "pallas_bf16"), run("gather", "pallas"))
    bf16 = [np.asarray(jnp.asarray(fpn[k], jnp.bfloat16).astype(jnp.float32)) for k in sorted(fpn)]
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_gather(bf16, boxes)), atol=ATOL, rtol=RTOL)


# --------------------------------------------------- the parity config's step


# RoIs sampled per image in the parity step: a quarter of the config's 512,
# since JAX's gather path materialises each RoI's whole 56 x 56 lattice
PARITY_ROI_BATCH = 128


@pytest.fixture(scope="module")
def parity_step():
    return train_step.jax_and_port_step(PARITY, PARITY_ROI_BATCH)


def test_parity_config_losses_and_stats_match_jax(parity_step):
    """``*_parity.yaml``: f32, gather levels, the adaptive grid."""
    from openset_rcnn_tpu_torch.config import get_default_cfg

    cfg = train_step.load_cfg(get_default_cfg, PARITY, PARITY_ROI_BATCH)
    assert (cfg.TPU.ROI_SAMPLING_RATIO, cfg.TPU.ROI_ALIGN_IMPL, cfg.TPU.DTYPE) == (-1, "gather", "float32")
    train_step.test_losses_and_stats_match_jax(parity_step)


def test_parity_config_head_gradients_match_jax(parity_step):
    train_step.test_head_gradients_match_jax(parity_step)


@pytest.mark.parametrize("reference", ["stock", "f32_acc"])
def test_parity_config_trunk_gradients_match_jax(parity_step, reference):
    train_step.test_trunk_gradients_match_jax(parity_step, reference)
