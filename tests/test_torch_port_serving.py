"""The serving slice of the PyTorch port against the JAX package, on the CPU:
the fused open-set cascade, and the whole path from pixels to detections
(``Predictor`` against ``CompiledInference`` with a ``post_cfg``)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_rcnn_tpu.config import get_default_cfg as jax_cfg
from openset_rcnn_tpu.evaluation.postprocess import PostprocessConfig
from openset_rcnn_tpu.evaluation.testing import CompiledInference
from openset_rcnn_tpu.models import detector as jax_det
from openset_rcnn_tpu.models.serving import fused_cascade as jax_cascade
from openset_rcnn_tpu.structures import RawDetections as JaxRaw
from openset_rcnn_tpu_torch.config import get_default_cfg as port_cfg
from openset_rcnn_tpu_torch.evaluation.inference import Predictor
from openset_rcnn_tpu_torch.models.serving import fused_cascade as port_cascade
from openset_rcnn_tpu_torch.ops.nms import nms_keep_plain
from openset_rcnn_tpu_torch.structures import RawDetections as PortRaw
from openset_rcnn_tpu_torch.utils.jax_params import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml"
RAW_FIELDS = ("boxes", "objectness", "pred_iou", "centerness", "min_dist", "pln_class", "known_probs", "valid")


def assert_close(got, want, tol):
    """|got - want| <= tol * max(1, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def make_raw(rng, B, P, K):
    """Raw detections with tied objectness, ~10% invalid, and peaked class
    probabilities so the known branch has many (box, class) candidates."""
    xy = rng.uniform(0, 300, (B, P, 2))
    wh = rng.uniform(20, 120, (B, P, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    obj = (rng.randint(0, 40, (B, P)) / 40.0).astype(np.float32)
    logits = rng.randn(B, P, K + 1).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return dict(
        boxes=boxes, objectness=obj, pred_iou=obj, centerness=obj,
        min_dist=rng.uniform(0, 1, (B, P)).astype(np.float32),
        pln_class=np.zeros((B, P), np.int32), known_probs=probs.astype(np.float32),
        valid=rng.rand(B, P) > 0.1,
    )


@pytest.mark.parametrize("stage1_topk, max_known_candidates", [(200, 150), (1000, 2000)])
def test_fused_cascade_matches_jax(rng, stage1_topk, max_known_candidates):
    raw = make_raw(rng, 3, 300, 5)
    kw = dict(obj_thresh=0.05, unk_thr=0.5, known_score_thresh=0.05, known_nms_thresh=0.5, known_topk=50,
              unknown_score_thresh=0.0, unknown_nms_thresh=0.5, unknown_topk=50, unknown_id=80,
              stage1_topk=stage1_topk, max_known_candidates=max_known_candidates)
    want = jax.jit(lambda r: jax_cascade(r, **kw))(JaxRaw(**{k: jnp.asarray(v) for k, v in raw.items()}))
    got = port_cascade(PortRaw(**{k: torch.from_numpy(v) for k, v in raw.items()}), keep_fn=nms_keep_plain, **kw)
    for name in ("valid", "classes", "known_overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert_close(got.boxes, want.boxes, 1e-6)
    assert_close(got.scores, want.scores, 1e-6)
    valid = np.asarray(want.valid)
    assert valid[:, :50].any() and valid[:, 50:].any()  # both branches kept boxes
    assert (np.asarray(want.known_overflow) > 0).any() == (max_known_candidates == 150)


def load_cfg(get_default_cfg, unk_thr=None):
    cfg = get_default_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 50
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0  # proposals of positive size from a random init
    if unk_thr is not None:
        cfg.MODEL.PLN.UNK_THR = unk_thr
    return cfg


def test_predictor_matches_compiled_inference():
    """Pixels -> RawDetections -> ServeDetections, full R50-FPN with bridged
    weights on a small batch: raw floats within 1e-4 (scaled), detection
    masks and classes exactly."""
    rng = np.random.RandomState(1)
    B, H, W = 2, 64, 96
    cfg = load_cfg(jax_cfg)
    id_map = jax_det.opendet_id_map(81, 20)
    spec = jax_det.ModelSpec.from_cfg(cfg, id_map)
    module = jax_det.OpensetRCNNModule(spec=spec)
    params = jax.jit(lambda: module.init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)))["params"])()
    # tempered as in test_torch_port_models: unsaturated heads, known candidates
    params = jax.tree.map(np.array, params)
    params["box_head"]["fc1"]["kernel"] *= 0.02
    params["classifier"]["cls_score"]["bias"] = rng.normal(0.0, 1.5, 21).astype(np.float32)
    images = (np.asarray(cfg.MODEL.PIXEL_MEAN, np.float32) + rng.uniform(-4, 4, (B, H, W, 3))).astype(np.float32)
    image_hw = np.asarray([[64.0, 96.0], [52.0, 80.0]], np.float32)

    raw_j = jax.tree.map(np.asarray, CompiledInference(module, params, spec)(images, image_hw))
    # split the proposals about evenly between the unknown and known branches
    unk_thr = float(np.median(raw_j.min_dist[raw_j.valid]))
    post_cfg = PostprocessConfig.from_cfg(load_cfg(jax_cfg, unk_thr), opendet_benchmark=True)
    serve_j = jax.tree.map(np.asarray, CompiledInference(module, params, spec, post_cfg=post_cfg)(images, image_hw))

    predictor = Predictor(load_cfg(port_cfg, unk_thr), device="cpu", seed=123)
    predictor.model.load_state_dict(state_dict_from_jax(params, predictor.model.state_dict().keys()))
    raw = predictor.raw(torch.from_numpy(images), torch.from_numpy(image_hw))
    for name in RAW_FIELDS:
        got, want = getattr(raw, name).numpy(), getattr(raw_j, name)
        if want.dtype.kind in "bi":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert_close(got, want, 1e-4)
    serve = predictor(torch.from_numpy(images), torch.from_numpy(image_hw))
    for name in ("valid", "classes", "known_overflow"):
        np.testing.assert_array_equal(getattr(serve, name).numpy(), getattr(serve_j, name), err_msg=name)
    assert_close(serve.boxes, serve_j.boxes, 1e-4)
    assert_close(serve.scores, serve_j.scores, 1e-4)
    assert serve_j.valid[:, :50].any() and serve_j.valid[:, 50:].any()  # both branches kept boxes


def test_predictor_without_gpu_raises_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(load_cfg(port_cfg))
