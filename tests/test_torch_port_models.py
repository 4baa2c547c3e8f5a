"""Model modules of the PyTorch port against the JAX package, on the CPU.

JAX params of the full R50-FPN model are bridged into the port
(utils/jax_params.py); each module then gets the same numpy inputs on both
sides, in f32, on a 64 x 96 canvas. Float outputs agree within 1e-4 scaled
to their magnitude; integer and boolean outputs exactly.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_rcnn_tpu.config import get_default_cfg as jax_cfg
from openset_rcnn_tpu.models import detector as jax_det
from openset_rcnn_tpu.models import roi_heads as jax_heads
from openset_rcnn_tpu.models import rpn as jax_rpn
from openset_rcnn_tpu.ops.box_transforms import Box2BoxTransform as JaxTf
from openset_rcnn_tpu.ops.box_transforms import Box2BoxTransformLinear as JaxLinearTf
from openset_rcnn_tpu.structures import Proposals as JaxProposals
from openset_rcnn_tpu_torch.config import get_default_cfg as port_cfg
from openset_rcnn_tpu_torch.models import detector as port_det
from openset_rcnn_tpu_torch.models import roi_heads as port_heads
from openset_rcnn_tpu_torch.models import rpn as port_rpn
from openset_rcnn_tpu_torch.ops.box_transforms import Box2BoxTransform as PortTf
from openset_rcnn_tpu_torch.ops.box_transforms import Box2BoxTransformLinear as PortLinearTf
from openset_rcnn_tpu_torch.structures import Proposals as PortProposals
from openset_rcnn_tpu_torch.utils.jax_params import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml"
B, H, W = 2, 64, 96
IMAGE_HW = np.asarray([[64.0, 96.0], [50.0, 70.0]], np.float32)  # image 1 is padded
TOL = 1e-4


def load_cfg(get_default_cfg):
    cfg = get_default_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0  # proposals of positive size from a random init
    return cfg


def assert_close(got, want, tol=TOL):
    """|got - want| <= tol * max(1, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def tempered_params(params, rng):
    """The JAX random init, with the box-head FC scaled down and a random
    classifier bias, so the sigmoid/softmax heads are not saturated and the
    known branch of the cascade has candidates."""
    params = jax.tree.map(np.array, params)
    params["box_head"]["fc1"]["kernel"] *= 0.02
    params["classifier"]["cls_score"]["bias"] = rng.normal(0.0, 1.5, 21).astype(np.float32)
    return params


def make_images(rng, mean):
    """Pixels near the mean keep the random-init trunk's activations moderate."""
    return (np.asarray(mean, np.float32) + rng.uniform(-4.0, 4.0, (B, H, W, 3))).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    cfg = load_cfg(jax_cfg)
    id_map = jax_det.opendet_id_map(81, 20)
    spec = jax_det.ModelSpec.from_cfg(cfg, id_map)
    module = jax_det.OpensetRCNNModule(spec=spec)
    params = jax.jit(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"])()
    params = tempered_params(params, rng)
    pspec = port_det.ModelSpec.from_cfg(load_cfg(port_cfg))
    model = port_det.OpensetRCNN(pspec)
    model.load_state_dict(state_dict_from_jax(params, model.state_dict().keys()))
    model = model.to(memory_format=torch.channels_last).eval()
    images = make_images(rng, cfg.MODEL.PIXEL_MEAN)
    return dict(rng=rng, spec=spec, pspec=pspec, module=module, params=params, model=model, images=images)


@pytest.fixture(scope="module")
def jax_features(setup):
    module, params = setup["module"], setup["params"]

    @jax.jit
    def run(images, hw):
        x = module.apply({"params": params}, images, hw, method=jax_det.OpensetRCNNModule.preprocess)
        res = module.apply({"params": params}, x, method=lambda m, x: m.backbone(x))
        fpn = module.apply({"params": params}, res, method=lambda m, r: m.fpn(r))
        return x, res, fpn

    return jax.tree.map(np.asarray, run(setup["images"], IMAGE_HW))


def test_model_spec_from_cfg_matches_jax(setup):
    jax_fields = setup["spec"]._asdict()
    # MODEL.SWIN.WINDOW, which JAX's spec does not carry to its trunk, and MODEL.MVIT (MViTv2-T's defaults)
    # and MODEL.EVA02 (EVA-02-L's), trunks JAX does not have
    port_only = {"swin_window": 7, "mvit": port_det.MViTConfig(), "eva02": port_det.EVA02Config()}
    assert setup["pspec"]._asdict() == {**{k: jax_fields[k] for k in port_det.ModelSpec._fields
                                           if k not in port_only}, **port_only}


def test_remat_raises_until_ported():
    """TPU.REMAT is read as JAX reads it and is ported (the name is from
    before): ``true`` builds, each ResNet block runs again in the backward
    (``torch.utils.checkpoint``), and one CPU training step's gradients and
    losses are bitwise those without it."""
    from openset_rcnn_tpu_torch.engine.optimizer import freeze
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch
    from tests.test_torch_port_train_step import make_batch

    cfg = load_cfg(port_cfg)
    assert port_det.ModelSpec.from_cfg(cfg).remat is False
    cfg.TPU.REMAT = True
    spec = port_det.ModelSpec.from_cfg(cfg)
    jcfg = load_cfg(jax_cfg)
    jcfg.TPU.REMAT = True
    assert spec.remat is jax_det.ModelSpec.from_cfg(jcfg, jax_det.opendet_id_map(81, 20)).remat is True
    images, boxes, classes, valid = make_batch(np.random.RandomState(2), cfg.MODEL.PIXEL_MEAN)
    batch = ImageBatch(torch.from_numpy(images), torch.from_numpy(IMAGE_HW),
                       GroundTruth(torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(valid)))
    out = {}
    for remat in (False, True):
        model = port_det.build_model(spec._replace(remat=remat), "cpu", seed=0).train()
        assert model.backbone.remat is remat
        freeze(model, spec.freeze_at)
        calls = []
        model.backbone.res4_block2.register_forward_pre_hook(lambda *a: calls.append(1))
        anchors, level_sizes = port_det.compute_anchors(spec, (H, W))
        draws = port_det.sampling_draws(model, spec, len(images), len(anchors), level_sizes, boxes.shape[1],
                                        torch.Generator().manual_seed(5), "cpu")
        losses, _ = port_det.training_losses_and_stats(model, batch, spec, torch.from_numpy(anchors), level_sizes,
                                                       draws)
        sum(losses.values()).backward()
        out[remat] = ({k: v.detach() for k, v in losses.items()}, len(calls),
                      {n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    (l0, calls0, g0), (l1, calls1, g1) = out[False], out[True]
    assert (calls0, calls1) == (1, 2)  # the remat block ran again in the backward
    assert all(torch.equal(l0[k], l1[k]) for k in l0)
    assert set(g0) == set(g1) and len(g0) == 79
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_bridge_raises_on_missing_and_unmapped_keys(setup):
    keys = setup["model"].state_dict().keys()
    params = jax.tree.map(np.array, setup["params"])
    del params["pln"]["representatives"]
    with pytest.raises(KeyError, match="pln.representatives"):
        state_dict_from_jax(params, keys)
    params = jax.tree.map(np.array, setup["params"])
    params["box_head"]["fc3"] = {"kernel": np.zeros((4, 4), np.float32)}
    with pytest.raises(KeyError, match="box_head.fc3.weight"):
        state_dict_from_jax(params, keys)
    params = jax.tree.map(np.array, setup["params"])
    params["fpn"]["lateral_res2"]["gamma"] = np.zeros((4,), np.float32)
    with pytest.raises(KeyError, match="no mapping"):
        state_dict_from_jax(params, keys)


def test_preprocess_resnet_fpn_match_jax(setup, jax_features):
    model = setup["model"]
    x_j, res_j, fpn_j = jax_features
    with torch.no_grad():
        x = model.preprocess(torch.from_numpy(setup["images"]), torch.from_numpy(IMAGE_HW))
        np.testing.assert_array_equal(x.permute(0, 2, 3, 1).numpy(), x_j)  # incl. the exact-0.0 pad
        res = model.backbone(nchw(x_j))
        fpn = model.fpn({k: nchw(v) for k, v in res_j.items()})
    for k in ("res2", "res3", "res4", "res5"):
        assert_close(res[k].permute(0, 2, 3, 1), res_j[k])
    for k in ("p2", "p3", "p4", "p5", "p6"):
        assert_close(fpn[k].permute(0, 2, 3, 1), fpn_j[k])


def test_rpn_head_and_select_proposals_match_jax(setup, jax_features):
    module, params, model = setup["module"], setup["params"], setup["model"]
    fpn_j = jax_features[2]
    d_j, c_j, sizes = module.apply({"params": params}, fpn_j, method=jax_det.OpensetRCNNModule.rpn_predictions)
    with torch.no_grad():
        d, c, psizes = model.rpn_predictions({k: nchw(v) for k, v in fpn_j.items()})
    assert psizes == list(sizes)
    assert_close(d, d_j)
    assert_close(c, c_j)

    anchors, level_sizes = jax_det.compute_anchors(setup["spec"], (H, W))
    p_anchors, p_sizes = port_det.compute_anchors(setup["pspec"], (H, W))
    np.testing.assert_array_equal(p_anchors, anchors)
    assert p_sizes == level_sizes
    d_j, c_j = np.array(d_j), np.array(c_j)
    # centerness quantized to force ties beyond those of the padded canvas
    for ctr in (c_j, np.round(c_j * 64) / 64):
        want = jax_rpn.select_proposals(jnp.asarray(anchors), d_j, ctr, level_sizes, IMAGE_HW,
                                        JaxLinearTf(True), pre_topk=50)
        got = port_rpn.select_proposals(torch.from_numpy(anchors), torch.from_numpy(d_j), torch.from_numpy(ctr),
                                        level_sizes, torch.from_numpy(IMAGE_HW), PortLinearTf(True), pre_topk=50)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
        # decoded from distinct anchors: equal boxes mean equal top-k indices
        assert_close(got.boxes, want.boxes, 1e-6)


def test_roi_heads_and_raw_detections_match_jax(setup, jax_features):
    module, params, model, rng = setup["module"], setup["params"], setup["model"], setup["rng"]
    fpn_j = jax_features[2]
    S = 40
    xy = rng.uniform(0, 80, (B, S, 2))
    wh = rng.uniform(2, 60, (B, S, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)

    pooled_j = jax_heads.pool_features({k: jnp.asarray(v) for k, v in fpn_j.items()}, jnp.asarray(boxes),
                                       impl="gather")
    with torch.no_grad():
        pooled = port_heads.pool_features({k: nchw(v) for k, v in fpn_j.items()}, torch.from_numpy(boxes))
    assert pooled.dtype == torch.float32
    assert_close(pooled, pooled_j)

    def heads(m, x):
        feats = m.box_head(x)
        deltas, iou = m.box_predictor(feats)
        emb, rec, reps = m.pln(feats)
        return deltas, iou, emb, reps, m.classifier(rec)

    pooled_np = np.array(pooled_j)
    outs_j = jax.tree.map(np.asarray, module.apply({"params": params}, pooled_np, method=heads))
    with torch.no_grad():
        outs = model.roi_heads(torch.from_numpy(pooled_np))
    for got, want in zip(outs, outs_j):
        assert_close(got.detach(), want)

    scores = rng.uniform(0, 1, (B, S)).astype(np.float32)
    valid = rng.rand(B, S) > 0.2
    deltas, iou, emb, reps, logits = (np.array(o) for o in outs_j)
    spec = setup["spec"]
    want = jax_heads.raw_detections(
        JaxProposals(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)),
        deltas, iou, emb, reps, logits, IMAGE_HW, JaxTf(spec.bbox_reg_weights), 20, 1,
    )
    t = torch.from_numpy
    got = port_heads.raw_detections(
        PortProposals(t(boxes), t(scores), t(valid)), t(deltas), t(iou), t(emb), t(reps), t(logits),
        t(IMAGE_HW), PortTf(spec.bbox_reg_weights), 20, 1,
    )
    for name in ("boxes", "objectness", "pred_iou", "centerness", "min_dist", "known_probs"):
        assert_close(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.pln_class.numpy(), np.asarray(want.pln_class))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0.05 < float(np.asarray(want.objectness).std())  # heads are not saturated
