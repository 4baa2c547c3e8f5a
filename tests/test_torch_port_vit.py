"""The ViT-B backbone (ViTDet simple pyramid) of the PyTorch port against the
JAX package, on the CPU.

* ``bicubic_resize_matrix`` exactly (shrinking, stretching, the identity).
* ``ViTSimpleFPN`` at test size (embed 32, depth 3: two windowed blocks and
  one global, window 3, a 4 x 5 position table) on a 100 x 120 canvas, which
  is no multiple of the patch (the flax ``'SAME'`` patch embed pads it to a
  7 x 8 grid) nor of the window (the windowed blocks pad to 9 x 9), so the
  position table is resized: f32 within 1e-4 of max(1, max|want|); bf16 in
  bf16, the embedding, each block and the pyramid on JAX's bf16 input within
  ``MODULE_TOL`` = 2e-2 (see test_torch_port_swin.py); with JAX's drop-path
  masks, the f32 trunk again within 1e-4, and its backward (a seeded
  cotangent on every pyramid level) against ``jax.vjp`` within 1e-4 of each
  gradient's largest.
* The whole detector with ViT-B at full width
  (``configs/VOC-COCO/openset_rcnn_ViT_FPN_128k.yaml``: FREEZE_AT 0, norm
  clipping at 1.0) on 2 x 64 x 96: features and ``raw_detections``
  (test_torch_port_swin.py's comparison), then one training step against
  ``jax.value_and_grad``: losses and the gradients of the RPN head, box
  predictor, PLN and classifier within 1e-4 scaled, scalars exactly, the box
  head's within ``BOX_HEAD_TOL`` = 8e-2 of each tensor's largest (the
  constant says why), trunk gradients within ``VIT_TRUNK_TOL`` = 3e-2 of each
  tensor's largest (JAX with the RoIAlign backward summed in f32; the
  constant says why); the
  gradients after ``clip_gradients`` against optax's
  ``clip_by_global_norm(1.0)`` of JAX's at the same tolerances.
* The frozen set equal to JAX's ``trainable_mask`` (nothing, at FREEZE_AT 0).
* Drop-path off in ``Predictor`` and in ``do_test``.
"""
from pathlib import Path
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openset_rcnn_tpu.models import vit as jax_vit
from openset_rcnn_tpu_torch.engine.optimizer import clip_gradients, trainable_mask
from openset_rcnn_tpu_torch.models import vit as port_vit
from openset_rcnn_tpu_torch.utils.jax_params import state_dict_from_jax
from tests.port_threads import share_cores  # noqa: F401 (autouse)
from tests.test_torch_port_swin import (MODULE_TOL, backward_matches_jax_vjp,
                                        detector_features_and_raw_detections_match_jax, drop_path_stays_off, nhwc)
from tests.test_torch_port_train_step import (HEADS, TOL, assert_close, dropped_branches,
                                              intercepted, jax_and_port_step)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/VOC-COCO/openset_rcnn_ViT_FPN_128k.yaml"
SMALL = dict(embed_dim=32, depth=3, num_heads=2, window_size=3, pos_grid=(4, 5))
CANVAS = (2, 100, 120)
# trunk gradients of the full-width step, relative to each tensor's largest,
# against JAX with the f32-summed RoIAlign backward: the FPN maps and their
# cotangent are rounded to bf16 at RoIAlign on both sides, and the two sides
# sum in different orders, so a few values land on neighbouring bf16 numbers;
# twelve transformer blocks carry that into every trunk gradient (1.5e-2
# seen; stock JAX's bf16 scatter-add moves them by up to 3.1e-2 against the
# same reference). The trunk's backward itself is held at 1e-4 in
# test_vit_backward_matches_jax_vjp.
VIT_TRUNK_TOL = 3e-2
# the box head's gradients, relative to each tensor's largest: its pooled
# inputs (bf16 maps of unit scale, the pyramid ends in LayerNorms) differ
# between the two sides by up to a bf16 step on nearly every RoI, and half of
# its ReLUs sit at zero; the port's box head fed JAX's pooled features instead
# of its own moves these gradients by 2.3-4.8% under one cotangent (5.4e-2
# seen against JAX). The other heads' gradients hold at 1e-4.
BOX_HEAD_TOL = 8e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def small_pair(dtype, drop_path_rate=0.0, seed=0):
    jdt, tdt = DTYPES[dtype]
    x = np.random.RandomState(seed).normal(0.0, 1.0, (*CANVAS, 3)).astype(np.float32)
    module = jax_vit.ViTSimpleFPN(compute_dtype=jdt, drop_path_rate=drop_path_rate, **SMALL)
    params = jax.tree.map(np.array, jax.jit(module.init)(jax.random.PRNGKey(seed), x)["params"])
    model = port_vit.ViTSimpleFPN(compute_dtype=tdt, drop_path_rate=drop_path_rate, **SMALL)
    model.load_state_dict(state_dict_from_jax(params, model.state_dict().keys()))
    return module, params, model, x


def test_bicubic_resize_matrix_matches_jax():
    for out_size, in_size in ((52, 14), (84, 14), (4, 14), (7, 4), (14, 14), (1, 3)):
        want = jax_vit.bicubic_resize_matrix(out_size, in_size)
        got = port_vit.bicubic_resize_matrix(out_size, in_size)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_vit_f32_matches_jax():
    module, params, model, x = small_pair("float32")
    want = jax.jit(module.apply)({"params": params}, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == {"p2", "p3", "p4", "p5", "p6"}
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert_close(nhwc(got[k]), v, TOL, k)
    assert got["p4"].shape[2:] == (7, 8) and got["p6"].shape[2:] == (2, 2)  # 'SAME'; p6 = p5[::2, ::2]
    assert [getattr(model, f"block{i}").window_size for i in range(3)] == [3, 3, 0]


def test_vit_bf16_blocks_match_jax():
    """The patch embedding with its positions, each Block, and the pyramid
    of the bf16 model, on JAX's bf16 inputs."""
    module, params, model, x = small_pair("bfloat16")

    def record(ctx, args, out):
        if ctx.method_name != "__call__":
            return None
        if isinstance(ctx.module, jax_vit.Block):
            return ctx.module.name, (args[0].astype(jnp.float32), out.astype(jnp.float32))
        if isinstance(ctx.module, fnn.LayerNorm) and ctx.module.name == "norm":  # the trunk's last norm
            return ctx.module.name, (args[0].astype(jnp.float32), out.astype(jnp.float32))
        return None

    want, calls = intercepted(lambda p, im: module.apply({"params": p}, im), (params, x), record)
    calls = dict(calls)
    bf16 = lambda a: torch.from_numpy(np.array(a)).to(torch.bfloat16)
    with torch.no_grad():
        tokens = model.tokens(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert tokens.dtype == torch.bfloat16
        assert_close(tokens.float(), calls["block0"][0], MODULE_TOL, "tokens")
        for i in range(3):
            got = getattr(model, f"block{i}")(bf16(calls[f"block{i}"][0]))
            assert got.dtype == torch.bfloat16
            assert_close(got.float(), calls[f"block{i}"][1], MODULE_TOL, f"block{i}")
        pyramid = model.pyramid(bf16(calls["norm"][1]).permute(0, 3, 1, 2))
    for k, v in want.items():
        assert pyramid[k].dtype == torch.bfloat16 and v.dtype == jnp.bfloat16, k
        assert_close(nhwc(pyramid[k]), v.astype(np.float32), MODULE_TOL, k)


def test_vit_drop_path_matches_jax_masks():
    module, params, model, x = small_pair("float32", drop_path_rate=0.6)
    want, kept = intercepted(lambda p, im: module.apply({"params": p}, im, rngs={"dropout": jax.random.PRNGKey(5)}),
                             (params, x), dropped_branches)
    masks = torch.from_numpy(np.stack([m for _, m in kept]))
    assert masks.shape == (2 * 3, CANVAS[0]) and not masks.all() and masks[:2].all()  # block 0's rate is 0
    assert model.branch_rates == [0.0, 0.0, 0.3, 0.3, 0.6, 0.6]
    images = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got, off = model(images, drop_path=masks), model(images)
    for k, v in want.items():
        assert_close(nhwc(got[k]), v, TOL, k)
    for k, v in jax.jit(module.apply)({"params": params}, x).items():
        assert_close(nhwc(off[k]), v, TOL, k)


def test_vit_backward_matches_jax_vjp():
    backward_matches_jax_vjp(*small_pair("float32", drop_path_rate=0.6), jax.random.PRNGKey(5))


@pytest.fixture(scope="module")
def step():
    return jax_and_port_step(CONFIG)


def test_detector_features_and_raw_detections_match_jax(step):
    assert step["model"].fpn is None
    detector_features_and_raw_detections_match_jax(step)


def trunk_error(got, want):
    return float((got.double() - want.double()).abs().max()) / float(want.double().abs().max())


def test_step_losses_and_gradients_match_jax(step):
    want_losses, want_stats, _ = step["want"]
    for k, v in want_losses.items():
        assert_close(step["losses"][k].detach(), v, TOL, k)
    for k, v in want_stats.items():
        assert float(step["stats"][k]) == float(v), k
    model, want, f32_acc = step["model"], step["want_grads"], step["f32_acc_grads"]
    heads = trunk = 0
    for name, p in model.named_parameters():
        if name.startswith("box_head."):  # see BOX_HEAD_TOL
            assert trunk_error(p.grad, want[name]) <= BOX_HEAD_TOL, name
            heads += 1
        elif name.startswith(HEADS):
            assert_close(p.grad, want[name], TOL, name)
            heads += 1
        else:
            assert trunk_error(p.grad, f32_acc[name]) <= VIT_TRUNK_TOL, name
            trunk += 1
    assert heads == 21 and trunk == len(list(model.backbone.parameters())) == 12 * 12 + 33


def test_norm_clipping_matches_optax(step):
    """``clip_gradients(..., "norm", 1.0)`` (SOLVER.CLIP_GRADIENTS of the
    config) on the port's gradients against ``optax.clip_by_global_norm`` on
    JAX's (f32-summed RoIAlign backward): the norm is above the limit, so
    every gradient is scaled."""
    cfg = step["cfg"].SOLVER.CLIP_GRADIENTS
    assert cfg.ENABLED and cfg.CLIP_TYPE == "norm" and cfg.CLIP_VALUE == 1.0
    model, f32_acc = step["model"], step["f32_acc_grads"]
    names = [n for n, _ in model.named_parameters()]
    grads = [SimpleNamespace(grad=p.grad.clone()) for p in model.parameters()]
    clip_gradients(grads, cfg.CLIP_TYPE, cfg.CLIP_VALUE)
    jax_grads = [f32_acc[n].numpy() for n in names]
    assert float(optax.global_norm(jax_grads)) > 2 * cfg.CLIP_VALUE
    clipped, _ = optax.clip_by_global_norm(cfg.CLIP_VALUE).update(jax_grads, optax.EmptyState())
    for name, got, want in zip(names, grads, clipped):
        want = torch.from_numpy(np.array(want))
        if name.startswith("box_head."):
            assert trunk_error(got.grad, want) <= BOX_HEAD_TOL, name
        elif name.startswith(HEADS):
            assert_close(got.grad, want, TOL, name)
        else:
            assert trunk_error(got.grad, want) <= VIT_TRUNK_TOL, name


def test_frozen_set_matches_jax_trainable_mask(step):
    jax_mask = state_dict_from_jax(jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                                step["jax_mask"], step["params"]), step["model"].state_dict().keys())
    port_mask = trainable_mask([n for n, _ in step["model"].named_parameters()], step["pspec"].freeze_at)
    assert step["pspec"].freeze_at == 0
    assert port_mask == {n: bool(jax_mask[n].all()) for n in port_mask}
    assert all(port_mask.values()) and all(p.requires_grad for p in step["model"].parameters())


def test_drop_path_off_in_predictor_and_do_test(tmp_path, monkeypatch):
    drop_path_stays_off(port_vit.ViTSimpleFPN, CONFIG, tmp_path, monkeypatch)
