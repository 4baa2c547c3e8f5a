"""The training slice of the PyTorch port against the JAX package, on the CPU.

Full R50-FPN at 2 x 64 x 96 with JAX parameters bridged into the port
(utils/jax_params.py): ``training_losses_and_stats`` and its gradients
against ``jax.value_and_grad`` of JAX's, with the frozen leaves under
``stop_gradient`` as ``engine/train_state.py:44-68`` puts them, and the
samplers fed the uniforms of JAX's key tree.

Tolerances. Losses, and the gradients of the RPN head and of the ROI heads,
within 1e-4 scaled to their magnitude; the training scalars exactly. Two
roundings to bf16 set the rest:

* The FPN maps are cast to bf16 for RoIAlign. They agree to ~1e-6 relative,
  not bitwise, so ~0.2% of their values round to neighbouring bf16 numbers on
  the two sides (one bf16 step is 2^-8 relative). ``box_head.fc1``'s weight
  gradient multiplies the pooled values directly: within 2^-8 of its largest
  value.
* JAX on the CPU takes the RoIAlign backward through the gather path on bf16
  features, so its scatter-add rounds every contribution to bf16 and sums in
  bf16. The port sums in f32, as the TPU kernel does, and rounds once. So the
  FPN and backbone gradients agree with stock JAX only to bf16 accumulation
  error: within 6e-2 of each tensor's largest gradient (3.0e-2 seen). Against
  JAX with that one backward summed in f32 (the gather path's VJP taken on
  f32 copies of the features, then rounded to bf16), they agree within 1e-2
  of each tensor's largest gradient (3.5e-3 seen, from the bf16 steps above).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_rcnn_tpu.config import get_default_cfg as jax_cfg
from openset_rcnn_tpu.engine.optimizer import trainable_mask as jax_trainable_mask
from openset_rcnn_tpu.models import detector as jax_det
from openset_rcnn_tpu.models import roi_heads as jax_heads
from openset_rcnn_tpu.structures import GroundTruth as JaxGT
from openset_rcnn_tpu.structures import ImageBatch as JaxBatch
from openset_rcnn_tpu_torch.config import get_default_cfg as port_cfg
from openset_rcnn_tpu_torch.engine.optimizer import freeze
from openset_rcnn_tpu_torch.engine.train_state import Trainer
from openset_rcnn_tpu_torch.models import detector as port_det
from openset_rcnn_tpu_torch.structures import GroundTruth as PortGT
from openset_rcnn_tpu_torch.structures import ImageBatch as PortBatch
from openset_rcnn_tpu_torch.utils.jax_params import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml"
B, H, W, G = 2, 64, 96, 8
IMAGE_HW = np.asarray([[64.0, 96.0], [50.0, 70.0]], np.float32)
TOL = 1e-4
BF16_STEP = 2.0**-8  # box_head.fc1 weight gradient, relative; see the module docstring
TRUNK_TOL = {"stock": 6e-2, "f32_acc": 1e-2}  # trunk gradients, relative; see the module docstring
HEADS = ("rpn_head.", "box_head.", "box_predictor.", "pln.", "classifier.")


def load_cfg(get_default_cfg):
    cfg = get_default_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0  # proposals of positive size from a random init
    return cfg


def assert_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def make_batch(rng, mean):
    images = (np.asarray(mean, np.float32) + rng.uniform(-4.0, 4.0, (B, H, W, 3))).astype(np.float32)
    xy = rng.uniform(0, 60, (B, G, 2))
    wh = rng.uniform(10, 40, (B, G, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    classes = rng.randint(0, 81, (B, G)).astype(np.int32)
    classes[:, :3] = [[2, 5, 40], [11, 19, 70]]  # known, known, unknown
    valid = rng.rand(B, G) > 0.3
    valid[:, :3] = True
    return images, boxes, classes, valid


def rpn_uniforms(rpn_key, R):
    out = []
    for k in jax.random.split(rpn_key, B):
        per = []
        for kk in jax.random.split(k):  # (k_reg, k_obj)
            per.append([np.asarray(jax.random.uniform(q, (R,))) for q in jax.random.split(kk)])  # (kp, kn)
        out.append(per)
    return torch.from_numpy(np.asarray(out, np.float32))


def roi_uniforms(roi_key, N):
    return torch.from_numpy(np.asarray(
        [[np.asarray(jax.random.uniform(q, (N,))) for q in jax.random.split(k, 3)]  # (kp, kn, kt)
         for k in jax.random.split(roi_key, B)], np.float32))


_gather_roi_align = jax_heads.multilevel_roi_align_batched


def roi_align_with_f32_backward(feats, boxes, strides, out_size=7, sampling_ratio=2, impl="gather",
                                bwd_impl="pallas"):
    """JAX's gather-path RoIAlign whose backward sums in f32 and rounds to
    the features' dtype once, as the TPU kernel and the port do."""
    run = lambda fs: _gather_roi_align(fs, boxes, strides, out_size, sampling_ratio, impl="gather")

    @jax.custom_vjp
    def pool(fs):
        return run(fs)

    def bwd(fs, g):
        _, vjp = jax.vjp(run, tuple(f.astype(jnp.float32) for f in fs))
        return (tuple(d.astype(f.dtype) for d, f in zip(vjp(g)[0], fs)),)

    pool.defvjp(lambda fs: (run(fs), fs), bwd)
    return pool(tuple(feats))


@pytest.fixture(scope="module")
def step():
    rng = np.random.RandomState(0)
    cfg = load_cfg(jax_cfg)
    spec = jax_det.ModelSpec.from_cfg(cfg, jax_det.opendet_id_map(81, 20))
    module = jax_det.OpensetRCNNModule(spec=spec)
    params = jax.jit(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"])()
    # tempered as in test_torch_port_models: unsaturated heads
    params = jax.tree.map(np.array, params)
    params["box_head"]["fc1"]["kernel"] *= 0.02
    params["classifier"]["cls_score"]["bias"] = rng.normal(0.0, 1.5, 21).astype(np.float32)
    images, boxes, classes, valid = make_batch(rng, cfg.MODEL.PIXEL_MEAN)
    anchors, level_sizes = jax_det.compute_anchors(spec, (H, W))
    key = jax.random.PRNGKey(7)
    batch = JaxBatch(jnp.asarray(images), jnp.asarray(IMAGE_HW),
                     JaxGT(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid)))
    mask = jax_trainable_mask(params, spec.freeze_at)

    def loss_fn(p):
        p = jax.tree.map(lambda x, m: x if m else jax.lax.stop_gradient(x), p, mask)
        losses, stats = jax_det.training_losses_and_stats(module, p, batch, key, spec, jnp.asarray(anchors),
                                                          level_sizes)
        return sum(losses.values()), (losses, stats)

    (_, (losses, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = jax.tree.map(np.array, (losses, stats, grads))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_heads, "multilevel_roi_align_batched", roi_align_with_f32_backward)
        f32_grads = jax.tree.map(np.array, jax.jit(jax.grad(lambda p: loss_fn(p)[0]))(params))

    pspec = port_det.ModelSpec.from_cfg(load_cfg(port_cfg))
    model = port_det.OpensetRCNN(pspec)
    model.load_state_dict(state_dict_from_jax(params, model.state_dict().keys()))
    model = model.to(memory_format=torch.channels_last).train()
    trainable = freeze(model, pspec.freeze_at)
    rpn_key, roi_key = jax.random.split(key)
    uniforms = {"rpn": rpn_uniforms(rpn_key, len(anchors)), "roi": roi_uniforms(roi_key, sum(level_sizes) + G)}
    port_batch = PortBatch(torch.from_numpy(images), torch.from_numpy(IMAGE_HW),
                           PortGT(torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(valid)))
    got_losses, got_stats = port_det.training_losses_and_stats(
        model, port_batch, pspec, torch.from_numpy(anchors), level_sizes, uniforms=uniforms)
    sum(got_losses.values()).backward()
    keys = model.state_dict().keys()
    return dict(want=want, want_grads=state_dict_from_jax(want[2], keys),
                f32_acc_grads=state_dict_from_jax(f32_grads, keys),
                losses=got_losses, stats=got_stats, model=model, trainable=trainable)


def test_losses_and_stats_match_jax(step):
    want_losses, want_stats, _ = step["want"]
    assert set(step["losses"]) == set(want_losses) and len(want_losses) == 6
    assert set(step["stats"]) == set(want_stats) and len(want_stats) == 10
    for k, v in want_losses.items():
        assert_close(step["losses"][k].detach(), v, TOL, k)
        assert 0 < float(v) and np.isfinite(float(v)), k
    for k, v in want_stats.items():
        assert float(step["stats"][k]) == float(v), (k, float(step["stats"][k]), float(v))
    assert float(want_stats["roi_head/num_fg_samples"]) > 0


def test_head_gradients_match_jax(step):
    model, want = step["model"], step["want_grads"]
    checked = 0
    for name, p in model.named_parameters():
        if name.startswith(HEADS):
            if name == "box_head.fc1.weight":  # bf16-rounded inputs; see the module docstring
                assert_close(p.grad, want[name], BF16_STEP * float(want[name].abs().max()), name)
            else:
                assert_close(p.grad, want[name], TOL, name)
            checked += 1
    assert checked == 21


@pytest.mark.parametrize("reference", ["stock", "f32_acc"])
def test_trunk_gradients_match_jax(step, reference):
    model = step["model"]
    want = step["want_grads" if reference == "stock" else "f32_acc_grads"]
    checked = 0
    for name, p in model.named_parameters():
        if p.grad is None or name.startswith(HEADS):
            continue
        w = want[name].double()
        assert float(w.abs().max()) > 0, name
        err = float((p.grad.double() - w).abs().max()) / float(w.abs().max())
        assert err <= TRUNK_TOL[reference], (name, err)
        checked += 1
    assert checked == 58


def test_frozen_parameters_get_no_gradient(step):
    model, want = step["model"], step["want_grads"]
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert len(frozen) == 11 and all(n.startswith(("backbone.stem_", "backbone.res2_")) for n in frozen)
    for name, p in model.named_parameters():
        assert (p.grad is None) == (name in frozen), name
    for name in frozen:  # zero in JAX under stop_gradient
        assert not want[name].any(), name
    assert len(step["trainable"]) == len(list(model.parameters())) - len(frozen)


def test_trainer_steps_on_the_cpu_and_raises_without_a_gpu(monkeypatch):
    cfg = load_cfg(port_cfg)
    rng = np.random.RandomState(1)
    images, boxes, classes, valid = make_batch(rng, cfg.MODEL.PIXEL_MEAN)
    batch = PortBatch(torch.from_numpy(images), torch.from_numpy(IMAGE_HW),
                      PortGT(torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(valid)))
    cfg.SOLVER.WARMUP_ITERS = 0  # the full learning rate: every trainable tensor moves in one step
    a, b = Trainer(cfg, device="cpu", seed=3), Trainer(cfg, device="cpu", seed=3)
    frozen = {n: p.detach().clone() for n, p in a.model.named_parameters() if not p.requires_grad}
    buffers = {n: t.clone() for n, t in a.model.named_buffers()}
    before = {n: p.detach().clone() for n, p in a.model.named_parameters() if p.requires_grad}
    m1, m2 = a.step(batch), b.step(batch)
    assert a.state.step == 1
    assert set(m1) == {*step_keys(), "total_loss", "lr"}
    for k in m1:  # the step's draws are a function of (seed, step)
        assert torch.equal(m1[k], m2[k]), k
    assert float(m1["lr"]) == pytest.approx(cfg.SOLVER.BASE_LR)
    assert all(torch.equal(p, frozen[n]) for n, p in a.model.named_parameters() if n in frozen)
    assert all(torch.equal(t, buffers[n]) for n, t in a.model.named_buffers())
    assert all(not torch.equal(p, before[n]) for n, p in a.model.named_parameters() if n in before)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)


def step_keys():
    return ("loss_rpn_loc", "loss_rpn_ctr", "loss_box_reg", "loss_iou", "loss_dml", "loss_cls",
            "rpn/num_pos_anchors", "rpn/num_neg_anchors", "rpn/obj_num_pos_anchors", "rpn/obj_num_neg_anchors",
            "rpn/num_proposals", "roi_head/num_fg_samples", "roi_head/num_bg_samples",
            "softmax_classifier/cls_accuracy", "softmax_classifier/fg_cls_accuracy",
            "softmax_classifier/false_negative")
