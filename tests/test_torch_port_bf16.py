"""The production bf16 configuration of the PyTorch port against the JAX
package, on the CPU.

``configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml`` (``TPU.DTYPE
bfloat16``, ``TPU.ROI_ALIGN_BWD pallas_bf16``, batch 16): full R50-FPN at
2 x 64 x 96 with the JAX bf16 model's parameters bridged into the port.

Tolerances. XLA on the CPU and PyTorch on the CPU round bf16 convolution
and matmul outputs after different f32 summation orders, so values that
agree in f32 land on neighbouring bf16 numbers (one step is 2^-8 relative):

* per module, on the same bf16 inputs (JAX's outputs of the module before):
  within ``MODULE_TOL`` = 2e-2 of max(1, max|want|); ResNet-50 compounds
  fifty such layers (1.0e-2 seen at res4/res5), FPN, RPN head and box head
  one to five (1.4e-3, 7.6e-3, 6e-5 seen);
* the serving slice (``Predictor`` against ``CompiledInference``): every
  anchor of the small canvas is a proposal (``PRE_NMS_TOPK_TEST`` above the
  anchor count), so both sides pool the same proposals, but centerness
  computed from a bf16 conv output has many near-ties, which the two sides'
  last-bit differences put in different top-k orders. The raw outputs are
  therefore compared as per-image multisets (sorted values), which do not
  depend on that order, within ``SLICE_TOL`` = 2e-2 of max(1, max|want|)
  (2.5e-3 seen); the PLN class is an argmin over distances that agree to
  ~2e-3 and flips on near-ties, so it is not compared. Of the cascade's
  output, the valid detections per image and branch are counted exactly and
  their sorted scores compared, at least 90% of them within ``SLICE_TOL``
  (a detection at a threshold or an NMS near-tie may be exchanged);
* one training step (``training_losses_and_stats`` and its gradients against
  ``jax.value_and_grad``, JAX's own sampling draws): the six losses within
  1e-4 scaled, the ten training scalars exactly. Gradients through fifty
  bf16 layers are noisy on both sides: JAX's own bf16 gradients differ from
  its f32 gradients by 12-28% (relative L2) in the trunk at this size. Each
  gradient of the port is held within 1.5 times that noise of JAX's bf16
  gradient, ``rel_l2(port, jax_bf16) <= 1.5 * max(2e-2, rel_l2(jax_bf16,
  jax_f32))`` (1.25 times seen). The RoIAlign backward differs on purpose:
  JAX on the CPU takes it through the gather path's bf16 scatter-add, the
  port through the ``pallas_bf16`` accumulators (held against JAX's kernel
  in tests/test_torch_port_train_ops.py).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_rcnn_tpu.config import get_default_cfg as jax_cfg
from openset_rcnn_tpu.engine.optimizer import trainable_mask as jax_trainable_mask
from openset_rcnn_tpu.evaluation.postprocess import PostprocessConfig
from openset_rcnn_tpu.evaluation.testing import CompiledInference
from openset_rcnn_tpu.models import detector as jax_det
from openset_rcnn_tpu.structures import GroundTruth as JaxGT
from openset_rcnn_tpu.structures import ImageBatch as JaxBatch
from openset_rcnn_tpu_torch.config import get_default_cfg as port_cfg
from openset_rcnn_tpu_torch.engine.optimizer import freeze
from openset_rcnn_tpu_torch.evaluation.inference import Predictor
from openset_rcnn_tpu_torch.models import detector as port_det
from openset_rcnn_tpu_torch.structures import GroundTruth as PortGT
from openset_rcnn_tpu_torch.structures import ImageBatch as PortBatch
from openset_rcnn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_port_train_step import make_batch, roi_uniforms, rpn_uniforms

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml"
B, H, W, G = 2, 64, 96, 8
IMAGE_HW = np.asarray([[64.0, 96.0], [50.0, 70.0]], np.float32)
MODULE_TOL = 2e-2
SLICE_TOL = 2e-2
LOSS_TOL = 1e-4
GRAD_NOISE_FACTOR, GRAD_NOISE_FLOOR = 1.5, 2e-2
RAW_FLOAT_FIELDS = ("centerness", "objectness", "pred_iou", "min_dist")


def load_cfg(get_default_cfg, overrides=None):
    """The config with ``overrides`` {"A.B.KEY": value} applied."""
    cfg = get_default_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0  # proposals of positive size from a random init
    for key, value in (overrides or {}).items():
        *path, leaf = key.split(".")
        node = cfg
        for name in path:
            node = getattr(node, name)
        setattr(node, leaf, value)
    return cfg


def assert_close(got, want, tol, what=""):
    """|got - want| <= tol * max(1, max|want|), in f64."""
    got, want = np.asarray(got, np.float64), np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def nchw(x, dtype=torch.bfloat16):
    x = torch.from_numpy(np.array(x, np.float32))
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).to(dtype)


def nhwc(x):
    return x.float().permute(0, 2, 3, 1)


def jax_model(cfg, rng, seed=0):
    """The JAX bf16 module and its params, tempered as in
    test_torch_port_models: unsaturated heads, known candidates."""
    spec = jax_det.ModelSpec.from_cfg(cfg, jax_det.opendet_id_map(81, 20))
    module = jax_det.OpensetRCNNModule(spec=spec)
    params = jax.jit(lambda: module.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)))["params"])()
    params = jax.tree.map(np.array, params)
    params["box_head"]["fc1"]["kernel"] *= 0.02
    params["classifier"]["cls_score"]["bias"] = rng.normal(0.0, 1.5, 21).astype(np.float32)
    return spec, module, params


def port_model(params):
    pspec = port_det.ModelSpec.from_cfg(load_cfg(port_cfg))
    model = port_det.OpensetRCNN(pspec)
    model.load_state_dict(state_dict_from_jax(params, model.state_dict().keys()))
    return pspec, model.to(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    spec, module, params = jax_model(load_cfg(jax_cfg), rng)
    pspec, model = port_model(params)
    images = (np.asarray(load_cfg(jax_cfg).MODEL.PIXEL_MEAN, np.float32)
              + rng.uniform(-4.0, 4.0, (B, H, W, 3))).astype(np.float32)

    @jax.jit
    def run(images, hw):
        x = module.apply({"params": params}, images, hw, method=jax_det.OpensetRCNNModule.preprocess)
        res = module.apply({"params": params}, x, method=lambda m, x: m.backbone(x))
        fpn = module.apply({"params": params}, res, method=lambda m, r: m.fpn(r))
        return x, res, fpn

    features = jax.tree.map(np.asarray, run(images, IMAGE_HW))
    return dict(rng=rng, spec=spec, module=module, params=params, pspec=pspec, model=model.eval(),
                features=features)


def test_production_config_builds_in_bf16(setup):
    spec, pspec = setup["spec"], setup["pspec"]
    # MODEL.SWIN.WINDOW, which JAX's spec does not carry to its trunk, and MODEL.MVIT (MViTv2-T's defaults)
    # and MODEL.EVA02 (EVA-02-L's), trunks JAX does not have
    port_only = {"swin_window": 7, "mvit": port_det.MViTConfig(), "eva02": port_det.EVA02Config()}
    assert pspec._asdict() == {**{k: spec._asdict()[k] for k in port_det.ModelSpec._fields if k not in port_only},
                               **port_only}
    assert (pspec.compute_dtype, pspec.roi_align_impl, pspec.roi_align_bwd) == ("bfloat16", "auto", "pallas_bf16")
    built = port_det.build_model(port_det.ModelSpec.from_cfg(load_cfg(port_cfg)), "cpu")
    assert all(p.dtype == torch.float32 for p in built.parameters())
    assert all(b.dtype == torch.float32 for b in built.buffers())
    assert built.backbone.compute_dtype == built.fpn.compute_dtype == torch.bfloat16
    assert built.rpn_head.compute_dtype == built.box_head.compute_dtype == torch.bfloat16
    for key, value in (("TPU.DTYPE", "float16"), ("TPU.ROI_ALIGN_IMPL", "window"), ("TPU.ROI_ALIGN_BWD", "f64")):
        with pytest.raises(ValueError, match=key):
            port_det.OpensetRCNN(port_det.ModelSpec.from_cfg(load_cfg(port_cfg, {key: value})))


def test_resnet_bf16_matches_jax(setup):
    x_j, res_j, _ = setup["features"]
    with torch.no_grad():
        res = setup["model"].backbone(nchw(x_j, torch.float32))
    for k in ("res2", "res3", "res4", "res5"):
        assert res[k].dtype == torch.bfloat16, k  # FrozenBN's f32 buffers must not promote the trunk
        assert_close(nhwc(res[k]), res_j[k], MODULE_TOL, k)


def test_fpn_bf16_matches_jax(setup):
    _, res_j, fpn_j = setup["features"]
    with torch.no_grad():
        fpn = setup["model"].fpn({k: nchw(v) for k, v in res_j.items()})
    for k in ("p2", "p3", "p4", "p5", "p6"):
        assert fpn[k].dtype == torch.bfloat16, k
        assert_close(nhwc(fpn[k]), fpn_j[k], MODULE_TOL, k)


def test_rpn_head_bf16_matches_jax(setup):
    module, params, model = setup["module"], setup["params"], setup["model"]
    fpn_j = setup["features"][2]
    d_j, c_j, sizes = module.apply({"params": params}, fpn_j, method=jax_det.OpensetRCNNModule.rpn_predictions)
    with torch.no_grad():
        d, c, psizes = model.rpn_predictions({k: nchw(v) for k, v in fpn_j.items()})
    assert psizes == list(sizes)
    assert d.dtype == c.dtype == torch.float32
    assert_close(d, d_j, MODULE_TOL, "deltas")
    assert_close(c, c_j, MODULE_TOL, "centerness")


def test_box_head_bf16_matches_jax(setup):
    module, params, model = setup["module"], setup["params"], setup["model"]
    pooled = setup["rng"].randn(B, 40, 7, 7, 256).astype(np.float32)
    want = module.apply({"params": params}, pooled, method=lambda m, x: m.box_head(x))
    with torch.no_grad():
        got = model.box_head(torch.from_numpy(pooled))
    assert got.dtype == torch.float32
    assert_close(got, want, MODULE_TOL)


def sorted_close(got, want, tol, what):
    """Per-image multisets: sorted along the proposal axis (and per column)."""
    assert_close(np.sort(np.asarray(got, np.float64), axis=0), np.sort(np.asarray(want, np.float64), axis=0),
                 tol, what)


def test_predictor_matches_compiled_inference_bf16():
    rng = np.random.RandomState(1)
    image_hw = np.asarray([[64.0, 96.0], [52.0, 80.0]], np.float32)
    every_anchor = {"MODEL.RPN.PRE_NMS_TOPK_TEST": 1000}  # > the 384 anchors of P2 at 64 x 96
    cfg = load_cfg(jax_cfg, every_anchor)
    spec, module, params = jax_model(cfg, rng, seed=1)
    images = (np.asarray(cfg.MODEL.PIXEL_MEAN, np.float32) + rng.uniform(-4, 4, (B, H, W, 3))).astype(np.float32)
    raw_j = jax.tree.map(np.asarray, CompiledInference(module, params, spec)(images, image_hw))
    # split the proposals about evenly between the unknown and known branches
    unk_thr = float(np.median(raw_j.min_dist[raw_j.valid]))
    with_thr = {**every_anchor, "MODEL.PLN.UNK_THR": unk_thr}
    post_cfg = PostprocessConfig.from_cfg(load_cfg(jax_cfg, with_thr), opendet_benchmark=True)
    serve_j = jax.tree.map(np.asarray, CompiledInference(module, params, spec, post_cfg=post_cfg)(images, image_hw))

    predictor = Predictor(load_cfg(port_cfg, with_thr), device="cpu", seed=5)
    assert predictor.model.backbone.compute_dtype == torch.bfloat16
    predictor.model.load_state_dict(state_dict_from_jax(params, predictor.model.state_dict().keys()))
    raw = predictor.raw(torch.from_numpy(images), torch.from_numpy(image_hw))
    serve = predictor(torch.from_numpy(images), torch.from_numpy(image_hw))
    for b in range(B):
        v, gv = raw_j.valid[b], raw.valid[b].numpy()
        assert gv.sum() == v.sum() > 0
        for name in RAW_FLOAT_FIELDS:
            sorted_close(getattr(raw, name)[b].numpy()[gv], getattr(raw_j, name)[b][v], SLICE_TOL, name)
        sorted_close(raw.boxes[b].numpy()[gv], raw_j.boxes[b][v], SLICE_TOL, "boxes")
        sorted_close(raw.known_probs[b].numpy()[gv], raw_j.known_probs[b][v], SLICE_TOL, "known_probs")
        sv, wv = serve.valid[b].numpy(), serve_j.valid[b]
        K = predictor.post_cfg.unknown_topk  # unknown branch first, then known
        assert (sv[:K].sum(), sv[K:].sum()) == (wv[:K].sum(), wv[K:].sum())
        gs, ws = np.sort(serve.scores[b].numpy()[sv]), np.sort(serve_j.scores[b][wv])
        assert np.mean(np.abs(gs - ws) <= SLICE_TOL * max(1.0, float(np.abs(ws).max()))) >= 0.9
    assert serve_j.valid[:, :50].any() and serve_j.valid[:, 50:].any()  # both branches kept boxes


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def test_training_step_matches_jax_bf16():
    rng = np.random.RandomState(0)
    cfg = load_cfg(jax_cfg)
    spec, module, params = jax_model(cfg, rng)
    assert (spec.compute_dtype, spec.roi_align_bwd) == ("bfloat16", "pallas_bf16")
    spec32 = spec._replace(compute_dtype="float32")  # JAX's own bf16 noise: its distance to f32
    module32 = jax_det.OpensetRCNNModule(spec=spec32)
    images, boxes, classes, valid = make_batch(rng, cfg.MODEL.PIXEL_MEAN)
    anchors, level_sizes = jax_det.compute_anchors(spec, (H, W))
    key = jax.random.PRNGKey(7)
    batch = JaxBatch(jnp.asarray(images), jnp.asarray(IMAGE_HW),
                     JaxGT(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid)))
    mask = jax_trainable_mask(params, spec.freeze_at)

    def loss_fn(p, m, s):
        p = jax.tree.map(lambda x, k: x if k else jax.lax.stop_gradient(x), p, mask)
        losses, stats = jax_det.training_losses_and_stats(m, p, batch, key, s, jnp.asarray(anchors), level_sizes)
        return sum(losses.values()), (losses, stats)

    (_, (want_losses, want_stats)), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, module, spec), has_aux=True))(params)
    grads32 = jax.jit(jax.grad(lambda p: loss_fn(p, module32, spec32)[0]))(params)

    pspec, model = port_model(params)
    model = model.train()
    freeze(model, pspec.freeze_at)
    rpn_key, roi_key = jax.random.split(key)
    uniforms = {"rpn": rpn_uniforms(rpn_key, len(anchors)), "roi": roi_uniforms(roi_key, sum(level_sizes) + G)}
    port_batch = PortBatch(torch.from_numpy(images), torch.from_numpy(IMAGE_HW),
                           PortGT(torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(valid)))
    losses, stats = port_det.training_losses_and_stats(model, port_batch, pspec, torch.from_numpy(anchors),
                                                       level_sizes, uniforms=uniforms)
    sum(losses.values()).backward()

    assert set(losses) == set(want_losses) and set(stats) == set(want_stats)
    for k, v in want_losses.items():
        assert_close(losses[k].detach(), v, LOSS_TOL, k)
    for k, v in want_stats.items():
        assert float(stats[k]) == float(v), (k, float(stats[k]), float(v))
    keys = model.state_dict().keys()
    want = state_dict_from_jax(jax.tree.map(np.array, grads), keys)
    want32 = state_dict_from_jax(jax.tree.map(np.array, grads32), keys)
    checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and not want[name].any(), name
            continue
        assert p.grad.dtype == torch.float32, name
        noise = rel_l2(want[name], want32[name])
        err = rel_l2(p.grad, want[name])
        assert err <= GRAD_NOISE_FACTOR * max(GRAD_NOISE_FLOOR, noise), (name, err, noise)
        checked += 1
    assert checked == 79
