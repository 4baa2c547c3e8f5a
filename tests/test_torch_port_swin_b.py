"""Swin-B + FPN (``configs/VOC-COCO/openset_rcnn_SwinB_FPN_128k.yaml``) in
the port against the benchmark's plain reference, on the CPU at a small size.

The reference (``perfbench/reference/models/swin.py``) is a Swin written from
the paper and the detection code, independent of the port; both load one
seeded state dict.

* The port's Swin-B trunk against the reference at window 7 and at window 4
  (``MODEL.SWIN.WINDOW``) on a 36 x 44 canvas: 9 x 11 tokens at res2, no
  multiple of either window, and odd sides at the patch merges (9 -> 5 -> 3).
* The whole Swin-B detector's raw outputs against the reference detector
  (``build_swin_fpn_backbone``) on 2 x 64 x 96, every anchor a proposal,
  each image's values compared as multisets.
* The window repair: window 4 builds 49-row bias tables and masks of the
  window-4 grid; the Swin-T yaml builds bitwise the trunk it built before.
* The serving stages: Swin's four resolution stages as marks before
  "backbone" on the eager path, each a host span inside ``predict``, the
  ``swin.tokens`` / ``swin.window_tokens`` counters against a hand count;
  ResNet's and ViT's stage lists as they were.
* On the card (``cuda``): Swin-B's stage graphs bitwise the eager path, the
  marks between the same stages, the counters counted on the eager and the
  capturing call only.

Imports nothing of the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_swin_b.py
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from openset_rcnn_tpu_torch.config import get_default_cfg
from openset_rcnn_tpu_torch.evaluation.inference import Predictor
from openset_rcnn_tpu_torch.models import detector as port_det
from openset_rcnn_tpu_torch.models import swin as port_swin
from openset_rcnn_tpu_torch.models.detector import ModelSpec, OpensetRCNN, build_model, inference_stages
from openset_rcnn_tpu_torch.utils import tracing
from perfbench.reference import model as ref_model
from perfbench.reference.backbones import build_swin_fpn_backbone
from perfbench.reference.models import detector as ref_det

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs/VOC-COCO"
SWIN_B = CONFIGS / "openset_rcnn_SwinB_FPN_128k.yaml"
TOL = 1e-4
TRUNK = ["backbone.res2", "backbone.res3", "backbone.res4", "backbone.res5"]
STAGES = ["backbone", "rpn", "roi_align", "heads"]


@pytest.fixture(scope="module", autouse=True)
def share_cores():
    """Torch's threads as ``tests/port_threads.py`` sets them: each
    pytest-xdist worker's share of the cores, at least two. Set here, not
    imported: on the card this file runs without the repository's conftest,
    where an installed package named ``tests`` can shadow this directory."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(2, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def load_cfg(path=SWIN_B, window=None):
    cfg = get_default_cfg()
    cfg.merge_from_file(str(path))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0  # proposals of positive size from a random init
    if window is not None:
        cfg.MODEL.SWIN.WINDOW = window
    return cfg


def reference_cfg(cfg):
    return ref_model.Cfg(json.loads(json.dumps(cfg)))


def assert_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


def images_and_sizes(B, H, W, seed):
    """(B, H, W, 3) uint8 pixels, 0 beyond each image's (h, w), and the
    (B, 2) f32 sizes, as the loader gives them."""
    g = torch.Generator().manual_seed(seed)
    hw = torch.tensor([[H - 8 * i, W - 16 * i] for i in range(B)], dtype=torch.float32)
    images = torch.randint(0, 256, (B, H, W, 3), generator=g, dtype=torch.uint8)
    for i, (h, w) in enumerate(hw.long().tolist()):
        images[i, h:] = 0
        images[i, :, w:] = 0
    return images, hw


@pytest.fixture(scope="module")
def swin_b():
    """The port's Swin-B detector from the seeded init, and the reference
    detector with the same state dict."""
    cfg = load_cfg()
    model = build_model(ModelSpec.from_cfg(cfg), "cpu", seed=0)
    ref = ref_det.build_model(reference_cfg(cfg), "cpu", model.state_dict())
    return cfg, model, ref


@pytest.mark.parametrize("window", [7, 4])
def test_trunk_matches_the_reference(window):
    """Every output of the port's Swin-B trunk within 1e-4 of the
    reference's (scaled by max(1, max|want|)), at the window the config
    names."""
    cfg = load_cfg(window=window)
    model = build_model(ModelSpec.from_cfg(cfg), "cpu", seed=window)
    ref, widths = build_swin_fpn_backbone.build(reference_cfg(cfg), torch.float32)
    assert widths == (128, 256, 512, 1024) and model.backbone.out_channels == list(widths)
    ref.load_state_dict({k[len("backbone."):]: v for k, v in model.state_dict().items()
                         if k.startswith("backbone.")}, strict=True)
    x = torch.randn(2, 3, 36, 44, generator=torch.Generator().manual_seed(window))
    with torch.no_grad():
        got = model.backbone(x.contiguous(memory_format=torch.channels_last))
        want = ref.eval()(x)
    sides = {"res2": (9, 11), "res3": (5, 6), "res4": (3, 3), "res5": (2, 2)}
    assert set(got) == set(want) == set(sides)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape) == (2, widths[int(k[3]) - 2], *sides[k]), k
        assert_close(got[k], v, k)


def test_detector_raw_outputs_match_the_reference(swin_b):
    """P2-P6 within 1e-4; the raw detections of every anchor (each level has
    fewer anchors than the top-k) as per-image multisets: near-ties order
    the proposals differently."""
    cfg, model, ref = swin_b
    images, hw = images_and_sizes(2, 64, 96, seed=1)
    spec = model.spec
    anchors, level_sizes = port_det.compute_anchors(spec, (64, 96))
    assert max(level_sizes) <= spec.pre_nms_topk_test
    anchors = torch.from_numpy(anchors)
    with torch.no_grad():
        feats, want_feats = model.features(images, hw), ref.features(images, hw)
        got = port_det.inference_forward(model, images, hw, anchors, level_sizes)
        want = ref_det.inference_forward(ref, images, hw, anchors, level_sizes)
    for k, v in want_feats.items():
        assert_close(feats[k], v, k)
    assert torch.equal(got.valid.sum(1), want.valid.sum(1)) and int(want.valid.sum()) == 2 * len(anchors)
    for name in ("boxes", "objectness", "pred_iou", "centerness", "min_dist", "known_probs"):
        g, w = getattr(got, name), getattr(want, name)
        for i in range(2):
            assert_close(np.sort(g[i][got.valid[i]].numpy(), 0), np.sort(w[i][want.valid[i]].numpy(), 0), name)


def test_window_reaches_the_trunk():
    """``MODEL.SWIN.WINDOW`` 4: bias tables of (2 * 4 - 1)^2 = 49 rows, shift
    2 in the odd blocks, and the shift mask of the window-4 grid (9 x 11
    tokens pad to 12 x 12: 9 windows of 16)."""
    spec = ModelSpec.from_cfg(load_cfg(window=4))
    assert spec.swin_window == 4
    with torch.device("meta"):
        trunk = OpensetRCNN(spec).backbone
    assert trunk.window == 4
    for s, depth in enumerate(trunk.depths):
        for b in range(depth):
            block = getattr(trunk, f"stage{s}_block{b}")
            assert block.attn.rel_bias_table.shape == (49, (4, 8, 16, 32)[s])
            assert (block.window, block.shift) == (4, 0 if b % 2 == 0 else 2)
    mask = trunk.shift_mask(9, 11, torch.device("cpu"))
    assert mask.shape == (9, 16, 16)
    np.testing.assert_array_equal(mask.numpy(), port_swin._shift_mask(12, 12, 4, 2))


def test_swin_t_yaml_builds_the_trunk_it_built_before():
    """The Swin-T yaml (window 7 by default) gives the trunk that
    ``SwinTransformer`` gives without a window: the same leaves from the
    same seed, bitwise, and the same outputs bitwise."""
    cfg = load_cfg(CONFIGS / "openset_rcnn_SwinT_FPN_128k.yaml")
    spec = ModelSpec.from_cfg(cfg)
    assert spec.swin_window == 7
    got = OpensetRCNN(spec).backbone
    before = port_swin.SwinTransformer(size="T", drop_path_rate=spec.swin_drop_path)
    got.reset_parameters(torch.Generator().manual_seed(5))
    before.reset_parameters(torch.Generator().manual_seed(5))
    a, b = got.state_dict(), before.state_dict()
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    x = torch.randn(1, 3, 64, 96, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        out, want = got(x), before(x)
    assert all(torch.equal(out[k], want[k]) for k in want)


def hand_counts(B, H, W, window, depths=(2, 2, 18, 2)):
    """(tokens entering blocks, tokens attended once padded) of a forward on
    an H x W canvas, counted stage by stage."""
    h, w = -(-H // 4), -(-W // 4)
    tokens = padded = 0
    for s, depth in enumerate(depths):
        if s:
            h, w = -(-h // 2), -(-w // 2)
        tokens += depth * B * h * w
        padded += depth * B * (-(-h // window) * window) * (-(-w // window) * window)
    return tokens, padded


def test_eager_marks_spans_and_counters(swin_b):
    """One eager ``Predictor`` call on the CPU: the marks in stage order,
    Swin's four as host spans inside ``predict``, and the counters as
    counted by hand (64 x 96, batch 2: 16 x 24, 8 x 12, 4 x 6 and 2 x 3
    tokens; padded to 21 x 28, 14 x 14, 7 x 7, 7 x 7)."""
    cfg, model, _ = swin_b
    p = Predictor(cfg, device="cpu", state_dict=model.state_dict())
    images, hw = images_and_sizes(2, 64, 96, seed=2)
    marks = []
    tracing.enable()
    try:
        p(images, hw, mark=marks.append)
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    assert marks == TRUNK + STAGES + ["cascade"]
    assert hand_counts(2, 64, 96, 7) == (2 * (2 * 384 + 2 * 96 + 18 * 24 + 2 * 6),
                                         2 * (2 * 588 + 2 * 196 + 18 * 49 + 2 * 49))
    tokens, padded = hand_counts(2, 64, 96, 7)
    assert snap["counters"] == {"predict.eager": 1, "swin.tokens": tokens, "swin.window_tokens": padded}
    (predict,) = [s for s in snap["spans"] if s["name"] == "predict"]
    stages = [s for s in snap["spans"] if s["name"].startswith("stage.")]
    assert [s["name"] for s in stages] == ["stage." + m for m in TRUNK]
    assert all(s["parent"] == predict["id"] for s in stages)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(stages, stages[1:]))


@pytest.mark.parametrize("config, want", [
    ("openset_rcnn_R50_FPN_128k.yaml", STAGES),
    ("openset_rcnn_R50_FPN_128k_tpu.yaml", STAGES),
    ("openset_rcnn_ViT_FPN_128k.yaml", STAGES),
    ("openset_rcnn_SwinT_FPN_128k.yaml", TRUNK + STAGES),
    ("openset_rcnn_SwinB_FPN_128k.yaml", TRUNK + STAGES),
])
def test_stage_lists(config, want):
    """ResNet and the ViT give no stages of their own: their lists are the
    four stages they had; Swin's four come first."""
    with torch.device("meta"):
        model = OpensetRCNN(ModelSpec.from_cfg(load_cfg(CONFIGS / config)))
    assert [name for name, _ in inference_stages(model, None, [])] == want


@pytest.mark.cuda
def test_graphs_on_the_card(swin_b):
    """Swin-B on the card at batch 2: four calls, each bitwise the eager
    path, the marks between the same stages on the eager, capturing and
    replaying calls, and the counters counted on the first two only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    cfg, model, _ = swin_b
    dev = torch.device("cuda", 0)
    p = Predictor(cfg, dev, state_dict=model.state_dict())
    tracing.enable()
    try:
        for r in range(4):
            images, hw = images_and_sizes(2, 256, 384, seed=10 + r)
            marks = []
            out = p(images, hw, mark=marks.append)
            want = p.cascade(p.raw(images, hw))
            assert marks == TRUNK + STAGES + ["cascade"], r
            for name in want._fields:
                assert torch.equal(getattr(out, name), getattr(want, name)), (r, name)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
    kinds = ("predict.eager", "predict.graph.capture", "predict.graph.replay")
    assert {kind: counters.get(kind, 0) for kind in kinds} == dict(zip(kinds, (1, 1, 2)))
    tokens, padded = hand_counts(2, 256, 384, 7)
    # the eager and the capturing call, and the four eager ``raw`` calls
    assert counters["swin.tokens"] == 6 * tokens and counters["swin.window_tokens"] == 6 * padded
