"""The Swin-T backbone of the PyTorch port against the JAX package, on the CPU.

* The numpy helpers (``_rel_pos_index``, ``_shift_mask``) exactly.
* ``SwinTransformer`` at test size (embed 16, depths 2/2/2/2, window 7) on a
  70 x 90 canvas, which is no multiple of the patch (the flax ``'SAME'``
  patch embed pads it) nor of the window (every stage pads its windows, the
  shifted blocks roll the padded grid): f32 within 1e-4 of max(1, max|want|);
  bf16 in bf16, each block and patch merging on JAX's bf16 input within
  ``MODULE_TOL`` = 2e-2 (the per-module limit of
  tests/test_torch_port_bf16.py: XLA and PyTorch round bf16 matmul outputs
  after different f32 sums; a whole trunk compounds it to about JAX's own
  bf16-vs-f32 distance, 1-2e-2 at this size); with JAX's drop-path masks,
  the f32 trunk again within 1e-4, and its backward (a seeded cotangent on
  every output) against ``jax.vjp`` within 1e-4 of each gradient's largest.
* The whole detector with Swin-T at full width
  (``configs/VOC-COCO/openset_rcnn_SwinT_FPN_128k.yaml``, drop-path 0.2) on
  2 x 64 x 96: features and ``raw_detections`` in eval, then one training
  step against ``jax.value_and_grad`` with drop-path on and JAX's masks
  recovered (``test_torch_port_train_step.jax_drop_path_masks``): losses and
  head gradients within 1e-4 scaled, scalars exactly, trunk gradients within
  ``TRUNK_TOL["f32_acc"]`` of each tensor's largest (the bf16 RoIAlign
  backward of JAX on the CPU; see test_torch_port_train_step.py).
* The frozen set equal to JAX's ``trainable_mask`` (nothing, at FREEZE_AT 2).
* Drop-path off in ``Predictor`` (also on a model in train mode) and in
  ``do_test``.
"""
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_rcnn_tpu.models import swin as jax_swin
from openset_rcnn_tpu_torch.config import get_default_cfg as port_cfg
from openset_rcnn_tpu_torch.models import swin as port_swin
from openset_rcnn_tpu_torch.utils.jax_params import state_dict_from_jax
from tests.port_threads import share_cores  # noqa: F401 (autouse)
from tests.test_torch_port_train_step import (BF16_STEP, HEADS, TOL, TRUNK_TOL, assert_close, dropped_branches,
                                              intercepted, jax_and_port_step, load_cfg)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/VOC-COCO/openset_rcnn_SwinT_FPN_128k.yaml"
SMALL = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4))
CANVAS = (2, 70, 90)
MODULE_TOL = 2e-2
PRE_NMS_TOPK_ALL = 4096  # above the 1152 anchors of P2 at 64 x 96
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def nhwc(t):
    return np.asarray(t.permute(0, 2, 3, 1).float().detach())


def small_pair(dtype, drop_path_rate=0.0, seed=0):
    """The JAX and the port's test-size Swin with the same parameters, and a
    canvas of normal pixels."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.RandomState(seed).normal(0.0, 1.0, (*CANVAS, 3)).astype(np.float32)
    module = jax_swin.SwinTransformer(size="T", compute_dtype=jdt, drop_path_rate=drop_path_rate, **SMALL)
    params = jax.tree.map(np.array, jax.jit(module.init)(jax.random.PRNGKey(seed), x)["params"])
    model = port_swin.SwinTransformer(compute_dtype=tdt, drop_path_rate=drop_path_rate, **SMALL)
    model.load_state_dict(state_dict_from_jax(params, model.state_dict().keys()))
    return module, params, model, x


def test_numpy_helpers_match_jax():
    for w in (2, 3, 7):
        np.testing.assert_array_equal(port_swin._rel_pos_index(w), jax_swin._rel_pos_index(w))
    for hp, wp, w, shift in ((21, 28, 7, 3), (210, 336, 7, 3), (7, 7, 7, 3), (6, 9, 3, 1)):
        want = jax_swin._shift_mask(hp, wp, w, shift)
        got = port_swin._shift_mask(hp, wp, w, shift)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_swin_f32_matches_jax():
    module, params, model, x = small_pair("float32")
    want = jax.jit(module.apply)({"params": params}, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == {"res2", "res3", "res4", "res5"}
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(memory_format=torch.channels_last)
        assert_close(nhwc(got[k]), v, TOL, k)
    assert got["res2"].shape[2:] == (18, 23)  # 'SAME': ceil(70 / 4), ceil(90 / 4)


def test_swin_bf16_blocks_match_jax():
    """Each SwinBlock and PatchMerging, the patch embed with its norm, and
    the output norms of the bf16 trunk, on JAX's bf16 inputs."""
    module, params, model, x = small_pair("bfloat16")

    def record(ctx, args, out):
        if ctx.method_name == "__call__" and isinstance(ctx.module, (jax_swin.SwinBlock, jax_swin.PatchMerging,
                                                                     fnn.LayerNorm)):
            return ctx.module.name, (args[0].astype(jnp.float32), out.astype(jnp.float32))
        return None

    want, calls = intercepted(lambda p, im: module.apply({"params": p}, im), (params, x), record)
    checked = 0
    with torch.no_grad():
        embed = model.patch_norm(model.patch_embed(port_swin.same_pad(
            torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16), 4, 4)).permute(0, 2, 3, 1))
        for name, (inp, out) in calls:
            t = torch.from_numpy(np.array(inp)).to(torch.bfloat16)
            if name == "patch_norm":
                got = embed
            elif name.startswith(("stage", "downsample", "out_norm")):
                mod = getattr(model, name)
                got = mod(t, model.shift_mask(t.shape[1], t.shape[2], t.device)) if name.startswith("stage") else mod(t)
            else:  # a LayerNorm inside a block
                continue
            assert got.dtype == torch.bfloat16, name
            assert_close(got.float(), out, MODULE_TOL, name)
            checked += 1
        trunk = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert checked == 1 + 8 + 3 + 4
    for k, v in want.items():
        assert trunk[k].dtype == torch.bfloat16 and v.dtype == jnp.bfloat16, k


def test_swin_drop_path_matches_jax_masks():
    """Drop-path at rate 0.5 with JAX's masks: the same trunk in f32; without
    masks, the trunk without drop-path; with every sample kept, another
    trunk (kept branches scale by 1 / keep)."""
    module, params, model, x = small_pair("float32", drop_path_rate=0.5)
    want, kept = intercepted(lambda p, im: module.apply({"params": p}, im, rngs={"dropout": jax.random.PRNGKey(11)}),
                             (params, x), dropped_branches)
    masks = torch.from_numpy(np.stack([m for _, m in kept]))
    assert masks.shape == (2 * 8, CANVAS[0]) and not masks.all() and masks[0].all()  # block 0's rate is 0
    assert model.branch_rates == [r for i in range(8) for r in (0.5 * i / 7,) * 2]
    images = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(images, drop_path=masks)
        off, all_kept = model(images), model(images, drop_path=torch.ones_like(masks))
    for k, v in want.items():
        assert_close(nhwc(got[k]), v, TOL, k)
    plain = jax.jit(module.apply)({"params": params}, x)
    for k, v in plain.items():
        assert_close(nhwc(off[k]), v, TOL, k)
        # kept branches are scaled by 1 / keep: all kept is not drop-path off
        assert not np.allclose(nhwc(all_kept[k]), nhwc(off[k]), atol=1e-3), k


def backward_matches_jax_vjp(module, params, model, x, dropout_key):
    """The trunk's gradients for a seeded cotangent on every output, with
    JAX's drop-path masks of ``dropout_key``, against ``jax.vjp``: within
    1e-4 of each gradient's largest (zero where JAX's is zero)."""
    _, kept = intercepted(lambda p, im: module.apply({"params": p}, im, rngs={"dropout": dropout_key}),
                          (params, x), dropped_branches)
    masks = torch.from_numpy(np.stack([m for _, m in kept]))
    fwd = lambda p: module.apply({"params": p}, x, rngs={"dropout": dropout_key})
    rng = np.random.RandomState(8)
    cot = {k: rng.normal(0.0, 1.0, v.shape).astype(np.float32)
           for k, v in jax.eval_shape(fwd, params).items()}
    grads = jax.jit(lambda p, c: jax.vjp(fwd, p)[1](c)[0])(params, cot)
    want = state_dict_from_jax(jax.tree.map(np.array, grads), model.state_dict().keys())
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2), drop_path=masks)
    sum((got[k].permute(0, 2, 3, 1) * torch.from_numpy(c)).sum() for k, c in cot.items()).backward()
    for name, p in model.named_parameters():
        w = want[name].double()
        assert p.grad is not None, name
        if not w.any():
            assert not p.grad.any(), name
        else:
            assert_close(p.grad, w, TOL * float(w.abs().max()), name)


def test_swin_backward_matches_jax_vjp():
    backward_matches_jax_vjp(*small_pair("float32", drop_path_rate=0.5), jax.random.PRNGKey(11))


@pytest.fixture(scope="module")
def step():
    return jax_and_port_step(CONFIG, drop_path=True)


def test_detector_features_and_raw_detections_match_jax(step):
    detector_features_and_raw_detections_match_jax(step)


def detector_features_and_raw_detections_match_jax(step):
    """Features (eval: no drop-path) within 1e-4 scaled; raw detections with
    every anchor a proposal (top-k above each level's anchors), each image's
    values compared as multisets (sorted per field): near-ties of the
    centerness, which agrees to ~1e-6, order proposals differently."""
    from openset_rcnn_tpu.models import detector as jax_det
    from openset_rcnn_tpu_torch.models import detector as port_det
    from tests.test_torch_port_models import IMAGE_HW

    module, params, model, images = step["module"], step["params"], step["model"], step["images"]
    spec = step["spec"]._replace(pre_nms_topk_test=PRE_NMS_TOPK_ALL)
    anchors, level_sizes = jax_det.compute_anchors(spec, images.shape[1:3])
    assert max(level_sizes) <= PRE_NMS_TOPK_ALL

    @jax.jit
    def run(im, hw):
        feats = module.apply({"params": params}, im, hw, method=jax_det.OpensetRCNNModule.features)
        return feats, jax_det.inference_forward(module, params, im, hw, spec, jnp.asarray(anchors), level_sizes)

    want_feats, want = jax.tree.map(np.asarray, run(images, IMAGE_HW))
    pspec, model.spec = model.spec, model.spec._replace(pre_nms_topk_test=PRE_NMS_TOPK_ALL)
    model.eval()
    try:
        with torch.no_grad():
            feats = model.features(torch.from_numpy(images), torch.from_numpy(IMAGE_HW))
            got = port_det.inference_forward(model, torch.from_numpy(images), torch.from_numpy(IMAGE_HW),
                                             torch.from_numpy(anchors), level_sizes)
    finally:
        model.spec = pspec
        model.train()
    for k, v in want_feats.items():
        assert_close(nhwc(feats[k]), v, TOL, k)
    valid = want.valid
    np.testing.assert_array_equal(got.valid.sum(1).numpy(), valid.sum(1))
    assert valid.sum() == 2 * len(anchors)  # every anchor
    for name in ("boxes", "objectness", "pred_iou", "centerness", "min_dist", "known_probs"):
        g, w = getattr(got, name).numpy(), getattr(want, name)
        for i in range(len(valid)):
            assert_close(np.sort(g[i][got.valid[i].numpy()], 0), np.sort(w[i][valid[i]], 0), TOL, name)


def test_step_losses_and_gradients_match_jax(step):
    """Drop-path on (rate 0.2, JAX's masks): losses, scalars, head and trunk
    gradients."""
    assert step["pspec"].swin_drop_path == 0.2 and step["pspec"].swin_size == "T"
    masks = step["uniforms"]["drop_path"]
    assert masks.shape == (2 * 12, 2) and not masks.all()
    want_losses, want_stats, _ = step["want"]
    for k, v in want_losses.items():
        assert_close(step["losses"][k].detach(), v, TOL, k)
    for k, v in want_stats.items():
        assert float(step["stats"][k]) == float(v), k
    model, want, f32_acc = step["model"], step["want_grads"], step["f32_acc_grads"]
    heads = trunk = dropped = 0
    for name, p in model.named_parameters():
        w = (want if name.startswith(HEADS) else f32_acc)[name].double()
        if name == "box_head.fc1.weight":  # bf16-rounded inputs; see test_torch_port_train_step.py
            assert_close(p.grad, w, BF16_STEP * float(w.abs().max()), name)
            heads += 1
        elif name.startswith(HEADS):
            assert_close(p.grad, w, TOL, name)
            heads += 1
        else:
            if not w.any():  # a block whose branches were dropped in every sample
                assert not p.grad.any(), name
                dropped += 1
                continue
            err = float((p.grad.double() - w).abs().max()) / float(w.abs().max())
            assert err <= TRUNK_TOL["f32_acc"], (name, err)
            trunk += 1
    trunk_params = len(list(model.backbone.parameters())) + len(list(model.fpn.parameters()))
    assert heads == 21 and trunk + dropped == trunk_params


def test_frozen_set_matches_jax_trainable_mask(step):
    from openset_rcnn_tpu_torch.engine.optimizer import trainable_mask

    jax_mask = state_dict_from_jax(jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                                step["jax_mask"], step["params"]), step["model"].state_dict().keys())
    port_mask = trainable_mask([n for n, _ in step["model"].named_parameters()], step["pspec"].freeze_at)
    assert step["pspec"].freeze_at == 2
    assert port_mask == {n: bool(jax_mask[n].all()) for n in port_mask}
    assert all(port_mask.values())
    assert all(p.requires_grad for p in step["model"].parameters())


def drop_path_stays_off(backbone_cls, config, tmp_path, monkeypatch):
    """Every call of ``backbone_cls.forward`` made by ``Predictor`` (on its
    eval model and on the same model in train mode, as ``do_train``'s evals
    run it) and by ``do_test`` gets no drop-path masks, at a rate of 0.2."""
    from openset_rcnn_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from openset_rcnn_tpu_torch.data.synthetic import generate_synthetic_dataset
    from openset_rcnn_tpu_torch.engine.train_loop import do_test
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor
    from tests.test_e2e import CLASSES, make_cfg

    seen = []
    forward = backbone_cls.forward

    def spy(self, x, drop_path=None):
        seen.append(drop_path)
        return forward(self, x, drop_path=drop_path)

    monkeypatch.setattr(backbone_cls, "forward", spy)
    cfg = load_cfg(port_cfg, config)
    cfg.MODEL.SWIN.DROP_PATH_RATE = cfg.MODEL.VIT.DROP_PATH_RATE = 0.2
    predictor = Predictor(cfg, device="cpu")
    images = torch.from_numpy(np.random.RandomState(4).uniform(0, 255, (1, 64, 96, 3)).astype(np.float32))
    hw = torch.tensor([[64.0, 96.0]])
    first = predictor.raw(images, hw)
    predictor.model.train()
    again = predictor.raw(images, hw)
    assert torch.equal(first.boxes, again.boxes) and torch.equal(first.known_probs, again.known_probs)

    name = "port_drop_path_synth"
    records = generate_synthetic_dataset(str(tmp_path / "images"), num_images=2, image_hw=(120, 160),
                                         num_classes=3, seed=3)
    DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: records)
    MetadataCatalog.get(name).update(evaluator_type="voc_records", thing_classes=CLASSES)
    small = port_cfg()
    small.merge_from_other(make_cfg(tmp_path).to_dict())
    small.MODEL.BACKBONE.NAME = cfg.MODEL.BACKBONE.NAME
    small.MODEL.SWIN.DROP_PATH_RATE, small.MODEL.VIT.DROP_PATH_RATE = 0.2, 0.2
    small.MODEL.RPN.DELTA_BIAS_INIT = 1.0
    small.DATASETS.TEST = (name,)
    small.TPU.EVAL_BATCH_SIZE = 2
    try:
        results = do_test(small, datasets=[name], device="cpu")
    finally:
        DatasetCatalog.remove(name)
    assert name in results
    assert len(seen) >= 3 and all(m is None for m in seen)


def test_drop_path_off_in_predictor_and_do_test(tmp_path, monkeypatch):
    drop_path_stays_off(port_swin.SwinTransformer, CONFIG, tmp_path, monkeypatch)
