"""EVA-02 in the ViTDet frame (``configs/VOC-COCO/openset_rcnn_EVA02L_FPN_128k.yaml``)
in the port against the benchmark's plain reference, on the CPU at a small
size.

The reference (``perfbench/reference/models/eva02.py``) is EVA-02 written
from EVA-02/det's equations, independent of the port; both load one seeded
state dict, the q and v biases drawn at std 0.02 (never zeros).

The small trunk: width 64, depth 6 with global blocks 2 and 5, 4 heads of
width 16, SwiGLU hidden 170, window 4, a 4 x 4 position table, RoPE at pt
16 and global ft 96. On an 88 x 120 canvas its patch grid is 6 x 8 (no
multiple of the window: the windowed blocks pad it to 8 x 8), and the
table is resized.

* The trunk, its gradients (with drop-path masks) and a small detector's
  raw outputs through ``Predictor`` against the reference.
* RoPE against its closed form, pair by pair; q.k after RoPE in a window
  depends only on the offset between the two positions; SwiGLU with sub-LN
  against its equation.
* ViT-B's trunk, which runs through the same classes, bitwise the frozen
  ViT-B of ``perfbench/reference/models/vit.py``.
* The counters ``vit.window_tokens``, ``vit.global_tokens``,
  ``vit.attn_logits``, ``vit.rope_rows`` against a hand count; the
  ``backbone.trunk`` mark and span of an eager call; the stage list.
* The L yaml: 303,451,072 trunk parameters, by the hand formula too; two
  ``do_train`` steps at the small size.
* On the card (``cuda``): the small detector's stage graphs, the trunk's
  among them, bitwise the eager path.

Imports nothing of the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_eva02.py
"""
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from openset_rcnn_tpu_torch.config import get_default_cfg
from openset_rcnn_tpu_torch.evaluation.inference import Predictor
from openset_rcnn_tpu_torch.models import detector as port_det
from openset_rcnn_tpu_torch.models import vit as port_vit
from openset_rcnn_tpu_torch.models.detector import ModelSpec, OpensetRCNN, build_model, inference_stages
from openset_rcnn_tpu_torch.models.vit import EVA02Config, EVA02SimpleFPN
from openset_rcnn_tpu_torch.utils import tracing
from perfbench.reference import model as ref_model
from perfbench.reference.backbones import build_eva02_fpn_backbone
from perfbench.reference.models import detector as ref_det
from perfbench.reference.models import vit as ref_vit

ROOT = Path(__file__).resolve().parents[1]
EVA02_L = ROOT / "configs/VOC-COCO/openset_rcnn_EVA02L_FPN_128k.yaml"
TOL = 1e-4
STAGES = ["backbone.trunk", "backbone", "rpn", "roi_align", "heads"]
SMALL = dict(EMBED_DIM=64, DEPTH=6, NUM_HEADS=4, MLP_HIDDEN=170, WINDOW_SIZE=4, GLOBAL_BLOCKS=[2, 5], POS_GRID=4)
CANVAS = (88, 120)  # a 6 x 8 patch grid
COUNTERS = ("vit.window_tokens", "vit.global_tokens", "vit.attn_logits", "vit.rope_rows")


@pytest.fixture(scope="module", autouse=True)
def share_cores():
    """Torch's threads as ``tests/port_threads.py`` sets them (set here: on
    the card this file runs without the repository's conftest)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(2, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def load_cfg(small=True, **eva02):
    cfg = get_default_cfg()
    cfg.merge_from_file(str(EVA02_L))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0  # proposals of positive size from a random init
    cfg.MODEL.EVA02.update({**(SMALL if small else {}), **eva02})
    return cfg


def reference_cfg(cfg):
    return ref_model.Cfg(json.loads(json.dumps(cfg)))


def small_trunks(seed=0, **eva02):
    """The port's small trunk from a seeded init and the reference's with
    its state dict."""
    cfg = load_cfg(**eva02)
    port = EVA02SimpleFPN(EVA02Config.from_cfg(cfg.MODEL.EVA02))
    port.reset_parameters(torch.Generator().manual_seed(seed))
    ref, fpn_in = build_eva02_fpn_backbone.build(reference_cfg(cfg), torch.float32)
    assert fpn_in is None
    ref.load_state_dict(port.state_dict(), strict=True)
    return port, ref


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


def test_trunk_matches_the_reference():
    """P2-P6 of the small trunk on 88 x 120 within 1e-4 of the reference's,
    with non-zero q and v biases."""
    port, ref = small_trunks(seed=3)
    assert port.block0.attn.q_bias.abs().min() > 0 and port.block5.attn.v_bias.abs().min() > 0
    assert port.block0.attn.qkv.bias is None
    x = torch.randn(2, 3, *CANVAS, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = port(x.contiguous(memory_format=torch.channels_last))
        want = ref.eval()(x)
    sides = {"p2": (24, 32), "p3": (12, 16), "p4": (6, 8), "p5": (3, 4), "p6": (2, 2)}
    assert set(got) == set(want) == set(sides)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape) == (2, 256, *sides[k]), k
        assert_close(got[k], v, k)


@pytest.mark.parametrize("block, grid", [(0, (6, 8)), (2, (6, 8)), (1, (8, 8)), (5, (5, 7))])
def test_blocks_match_the_reference(block, grid):
    """One windowed and one global block, each on a grid that pads and on
    one that does not, within 1e-4 of the reference's."""
    port, ref = small_trunks(seed=block)
    pb, rb = getattr(port, f"block{block}"), getattr(ref, f"block{block}")
    H, W = grid
    x = torch.randn(2, H, W, 64, generator=torch.Generator().manual_seed(10 + block))
    window, glb = port._rope_tables(H, W, x.device)
    rope_win = build_rope(ref, 4, 4, 4)
    rope_glb = build_rope(ref, H, W, 96)
    with torch.no_grad():
        got = pb(x, None, window if pb.window_size else glb)
        want = rb(x, rope_win, rope_glb)
    assert_close(got, want, f"block{block}")


def build_rope(ref, h, w, ft):
    from perfbench.reference.models.eva02 import rope_freqs

    return rope_freqs(h, w, ref.rope_pt, ft, ref.head_dim)


def rope_by_pairs(x, rows, cols, head_dim):
    """The closed form, pair by pair in f64: x (L, d) at positions rows x
    cols (row-major); pair m of the first half turns by r' theta_m, of the
    second by c' theta_m, theta_m = 10000^(-2m / (d/2))."""
    x = np.asarray(x, np.float64)
    out = np.empty_like(x)
    half = head_dim // 2
    theta = [10000.0 ** (-2.0 * m / half) for m in range(half // 2)]
    for t in range(x.shape[0]):
        r, c = rows[t // len(cols)], cols[t % len(cols)]
        for m in range(head_dim // 2):
            pos, k = (r, m) if m < half // 2 else (c, m - half // 2)
            a = pos * theta[k]
            x1, x2 = x[t, 2 * m], x[t, 2 * m + 1]
            out[t, 2 * m] = x1 * math.cos(a) - x2 * math.sin(a)
            out[t, 2 * m + 1] = x2 * math.cos(a) + x1 * math.sin(a)
    return out


@pytest.mark.parametrize("h, w, pt, ft", [(4, 4, 16, 4), (16, 16, 16, 16), (5, 7, 16, 96), (52, 84, 16, 96)])
def test_rope_matches_the_closed_form(h, w, pt, ft):
    """``rope_tables`` and ``apply_rope`` (one head's rows, and the tables
    broadcast over (N, heads, L, d)) against the closed form, within 1e-5
    on unit-scale rows: the windows' tables (positions r * pt / window) and
    the global blocks' (r * 16 / 96), up to the 52 x 84 grid of 832 x 1344."""
    d = 64 if h > 8 else 16
    rows = np.arange(h) / ft * pt
    cols = np.arange(w) / ft * pt
    cos, sin = port_vit.rope_tables(torch.arange(h, dtype=torch.float64) / ft * pt,
                                    torch.arange(w, dtype=torch.float64) / ft * pt, d)
    assert cos.shape == sin.shape == (h * w, d) and cos.dtype == torch.float32
    x = torch.randn(2, 3, h * w, d, generator=torch.Generator().manual_seed(h * w))
    got = port_vit.apply_rope(x, cos, sin)
    for n, head in ((0, 0), (1, 2)):
        np.testing.assert_allclose(got[n, head].numpy(), rope_by_pairs(x[n, head].numpy(), rows, cols, d),
                                   rtol=0, atol=1e-5)


def test_windowed_qk_depends_only_on_the_offset():
    """One q and one k vector at every position of a 16 x 16 window (the
    L trunk's windows, pt = ft = 16): after RoPE, q_i . k_j is a function of
    (r_i - r_j, c_i - c_j) alone (within 1e-4 of unit-scale logits, f32
    tables), and it differs between offsets."""
    d, w = 64, 16
    inside = torch.arange(w, dtype=torch.float64)
    cos, sin = port_vit.rope_tables(inside, inside, d)
    g = torch.Generator().manual_seed(0)
    q = port_vit.apply_rope(torch.randn(d, generator=g).expand(w * w, d), cos, sin).double()
    k = port_vit.apply_rope(torch.randn(d, generator=g).expand(w * w, d), cos, sin).double()
    logits = (q @ k.T).numpy()
    by_offset = {}
    for i in range(w * w):
        for j in range(w * w):
            by_offset.setdefault((i // w - j // w, i % w - j % w), []).append(logits[i, j])
    assert len(by_offset) == (2 * w - 1) ** 2
    for offset, values in by_offset.items():
        assert max(values) - min(values) < 1e-4 * max(1.0, abs(values[0])), offset
    firsts = np.array([v[0] for v in by_offset.values()])
    assert np.ptp(firsts) > 1.0


def test_swiglu_with_sub_ln_matches_its_equation():
    """``mlp`` of a block: w3(LN(silu(w1 x) * w2 x)), LN over the hidden
    width with eps 1e-6 and its scale and bias, written out in f64."""
    port, _ = small_trunks(seed=7)
    mlp = port.block1.mlp
    with torch.no_grad():
        mlp.ffn_ln.scale.normal_(1.0, 0.1, generator=torch.Generator().manual_seed(8))
        mlp.ffn_ln.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(9))
    x = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = mlp(x)
    p = {k: v.double() for k, v in mlp.state_dict().items()}
    xd = x.double()
    a = xd @ p["w1.weight"].T + p["w1.bias"]
    b = xd @ p["w2.weight"].T + p["w2.bias"]
    h = a / (1.0 + torch.exp(-a)) * b
    mu, var = h.mean(-1, keepdim=True), h.var(-1, unbiased=False, keepdim=True)
    h = (h - mu) / torch.sqrt(var + 1e-6) * p["ffn_ln.scale"] + p["ffn_ln.bias"]
    want = h @ p["w3.weight"].T + p["w3.bias"]
    assert_close(got, want, "swiglu")


def test_vit_b_is_bitwise_the_frozen_vit_b():
    """ViT-B's classes, now shared with EVA-02, give bitwise what they gave
    before: the port's small ViT (embed 32, depth 3, window 3, a 4 x 5
    table) and the full-width ViT-B's first two blocks against the frozen
    copy in ``perfbench/reference/models/vit.py``, on one state dict."""
    small = dict(embed_dim=32, depth=3, num_heads=2, window_size=3, pos_grid=(4, 5))
    port = port_vit.ViTSimpleFPN(**small)
    port.reset_parameters(torch.Generator().manual_seed(0))
    ref = ref_vit.ViTSimpleFPN(**small)
    ref.load_state_dict(port.state_dict(), strict=True)
    x = torch.randn(2, 3, 100, 120, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = port(x), ref(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    full, frozen = port_vit.ViTSimpleFPN(), ref_vit.ViTSimpleFPN()
    full.reset_parameters(torch.Generator().manual_seed(2))
    frozen.load_state_dict(full.state_dict(), strict=True)
    y = torch.randn(1, 5, 7, 768, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for i in (0, 2):  # windowed (14, padded), global
            assert torch.equal(getattr(full, f"block{i}")(y), getattr(frozen, f"block{i}")(y)), i


def hand_counts(B, gh, gw, heads=4, w=4, windowed=4, glob=2):
    """The four counters of the small trunk on a gh x gw grid, by hand."""
    windows = B * -(-gh // w) * -(-gw // w)
    window_tokens = windowed * windows * w * w
    global_tokens = glob * B * gh * gw
    logits = windowed * heads * windows * (w * w) ** 2 + glob * heads * B * (gh * gw) ** 2
    return dict(zip(COUNTERS, (window_tokens, global_tokens, logits, 2 * heads * (window_tokens + global_tokens))))


def test_counters_by_hand():
    """One trunk call on 2 x 88 x 120 (6 x 8 tokens, padded to 2 x 2 windows
    of 4 x 4): 512 window tokens, 192 global, 69,632 logits, 5,632 rows
    rotated; ViT-B's trunk counts 0 rows rotated."""
    port, _ = small_trunks()
    want = hand_counts(2, 6, 8)
    assert want == dict(zip(COUNTERS, (512, 192, 69632, 5632)))
    tracing.enable()
    try:
        with torch.no_grad():
            port(torch.randn(2, 3, *CANVAS))
        got = tracing.snapshot()["counters"]
        tracing.disable()
        tracing.enable()
        with torch.no_grad():
            port_vit.ViTSimpleFPN(embed_dim=32, depth=3, num_heads=2, window_size=3, pos_grid=(4, 5))(
                torch.randn(1, 3, 64, 96))
        vit_b = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
    assert got == want
    # ViT-B's rule: 4 x 6 tokens, windows of 3 (2 x 2 of them), block 2 global
    assert vit_b == {"vit.window_tokens": 2 * 4 * 9, "vit.global_tokens": 24,
                     "vit.attn_logits": 2 * 2 * 4 * 81 + 2 * 24 ** 2, "vit.rope_rows": 0}


def test_detector_raw_outputs_match_the_reference():
    """The small EVA-02 detector through ``Predictor.raw`` (eager) against
    the reference detector on 2 x 64 x 96: P2-P6 within 1e-4, the raw
    detections of every anchor as per-image multisets."""
    cfg = load_cfg()
    model = build_model(ModelSpec.from_cfg(cfg), "cpu", seed=0)
    assert model.fpn is None and isinstance(model.backbone, EVA02SimpleFPN)
    ref = ref_det.build_model(reference_cfg(cfg), "cpu", model.state_dict())
    p = Predictor(cfg, device="cpu", state_dict=model.state_dict())
    images, hw = images_and_sizes(2, 64, 96, seed=1)
    anchors, level_sizes = port_det.compute_anchors(model.spec, (64, 96))
    assert max(level_sizes) <= model.spec.pre_nms_topk_test
    with torch.no_grad():
        feats, want_feats = p.model.features(images, hw), ref.features(images, hw)
        got = p.raw(images, hw)
        want = ref_det.inference_forward(ref, images, hw, torch.from_numpy(anchors), level_sizes)
    for k, v in want_feats.items():
        assert_close(feats[k], v, k)
    assert torch.equal(got.valid.sum(1), want.valid.sum(1)) and int(want.valid.sum()) == 2 * len(anchors)
    for name in ("boxes", "objectness", "pred_iou", "centerness", "min_dist", "known_probs"):
        g, w = getattr(got, name), getattr(want, name)
        for i in range(2):
            assert_close(np.sort(g[i][got.valid[i]].numpy(), 0), np.sort(w[i][want.valid[i]].numpy(), 0), name)


def test_eager_marks_spans_and_counters():
    """One eager ``Predictor`` call on the CPU (64 x 96, batch 2: 4 x 6
    tokens): the marks in stage order, the trunk first, its host span
    inside ``predict``, and the counters as counted by hand."""
    cfg = load_cfg()
    p = Predictor(cfg, device="cpu", state_dict=build_model(ModelSpec.from_cfg(cfg), "cpu", seed=2).state_dict())
    images, hw = images_and_sizes(2, 64, 96, seed=2)
    marks = []
    tracing.enable()
    try:
        p(images, hw, mark=marks.append)
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    assert marks == STAGES + ["cascade"]
    assert snap["counters"] == {"predict.eager": 1, **hand_counts(2, 4, 6)}
    (predict,) = [s for s in snap["spans"] if s["name"] == "predict"]
    (stage,) = [s for s in snap["spans"] if s["name"].startswith("stage.")]
    assert stage["name"] == "stage.backbone.trunk" and stage["parent"] == predict["id"]


def test_stage_list():
    """EVA-02's trunk comes before the pyramid's "backbone"; ViT-B keeps one
    backbone stage."""
    with torch.device("meta"):
        model = OpensetRCNN(ModelSpec.from_cfg(load_cfg(small=False)))
        vit_cfg = get_default_cfg()
        vit_cfg.merge_from_file(str(ROOT / "configs/VOC-COCO/openset_rcnn_ViT_FPN_128k.yaml"))
        vit_b = OpensetRCNN(ModelSpec.from_cfg(vit_cfg))
    assert [name for name, _ in inference_stages(model, None, [])] == STAGES
    assert [name for name, _ in inference_stages(vit_b, None, [])] == STAGES[1:]


def test_head_width_not_a_multiple_of_four_raises():
    """RoPE turns pairs in both halves of each head: a head width of 6 is
    refused when the trunk is built."""
    with pytest.raises(ValueError, match="multiple of 4"):
        EVA02SimpleFPN(EVA02Config(embed_dim=24, depth=1, num_heads=4, mlp_hidden=8, global_blocks=()))


def param_count(c: EVA02Config) -> int:
    """The trunk's parameters by hand: patch embedding, position table, the
    blocks, the final norm."""
    d, h = c.embed_dim, c.mlp_hidden
    block = 4 * d  # norm1, norm2
    block += 3 * d * d + 2 * d  # qkv without a bias, q_bias, v_bias
    block += d * d + d  # proj
    block += 2 * (d * h + h) + 2 * h + h * d + d  # w1, w2, ffn_ln, w3
    return 3 * 256 * d + d + c.pos_grid ** 2 * d + c.depth * block + 2 * d


def test_l_yaml_builds_the_published_trunk():
    """The L yaml's trunk: 303,451,072 parameters (the hand formula's),
    width 1024, 16 heads of 64, SwiGLU hidden 2730, eight global blocks,
    windows of 16, a 16 x 16 table."""
    spec = ModelSpec.from_cfg(load_cfg(small=False))
    assert spec.eva02 == EVA02Config(1024, 24, 16, 2730, 16, (2, 5, 8, 11, 14, 17, 20, 23), 16, 16, 96, 0.4)
    with torch.device("meta"):
        model = OpensetRCNN(spec)
    trunk = model.backbone
    pyramid = ("up2", "p2_", "p3_", "p4_", "p5_")
    n = sum(p.numel() for k, p in trunk.named_parameters() if not k.startswith(pyramid))
    assert n == param_count(spec.eva02) == 303_451_072
    assert [i for i in range(24) if getattr(trunk, f"block{i}").window_size == 0] == [2, 5, 8, 11, 14, 17, 20, 23]
    assert {getattr(trunk, f"block{i}").window_size for i in (0, 1, 3, 22)} == {16}
    assert trunk.block0.mlp.w1.weight.shape == (2730, 1024) and trunk.block0.attn.num_heads == 16
    assert trunk.pos_embed.shape == (16, 16, 1024) and trunk.head_dim == 64
    assert len(trunk.branch_rates) == 48 and trunk.branch_rates[-1] == pytest.approx(0.4)


def test_trunk_gradients_match_the_reference():
    """The small trunk's loss (a fixed weighting of P2-P6) and every
    parameter's gradient, with drop-path masks at rate 0.5, against the
    reference's autograd: within 1e-4 of each tensor's largest, or of a
    thousandth of the trunk's largest where a gradient cancels to rounding
    noise."""
    port, ref = small_trunks(seed=5, DROP_PATH_RATE=0.5)
    port.train()
    ref.train()
    x = torch.randn(2, 3, *CANVAS, generator=torch.Generator().manual_seed(6))
    g = torch.Generator().manual_seed(7)
    masks = port_det.drop_path_masks(port.branch_rates, 2, g, torch.device("cpu"))
    assert not masks.all() and masks.any()
    sides = {"p2": (24, 32), "p3": (12, 16), "p4": (6, 8), "p5": (3, 4), "p6": (2, 2)}
    weights = {k: torch.randn(2, 256, *side, generator=g) for k, side in sides.items()}
    losses = []
    for trunk, inp in ((port, x.contiguous(memory_format=torch.channels_last)), (ref, x)):
        outs = trunk(inp, drop_path=masks)
        loss = sum((outs[k] * w).sum() for k, w in weights.items())
        loss.backward()
        losses.append(float(loss.detach()))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    want = dict(ref.named_parameters())
    floor = 1e-3 * max(float(w.grad.abs().max()) for w in want.values())
    for name, p in port.named_parameters():
        assert p.grad is not None and want[name].grad is not None, name
        scale = max(float(want[name].grad.abs().max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), want[name].grad.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_do_train_steps_the_small_trunk(tmp_path, monkeypatch):
    """``do_train`` on the EVA-02 yaml at the small size: two steps at
    batch 1 on a 128 x 160 bucket of synthetic images, drop-path 0.4
    drawn, each to a finite loss."""
    from openset_rcnn_tpu_torch.data import DatasetCatalog, MetadataCatalog, generate_synthetic_dataset
    from openset_rcnn_tpu_torch.engine import checkpoint, train_loop

    name = "port_eva02_train"
    records = generate_synthetic_dataset(str(tmp_path / "train"), num_images=2, image_hw=(120, 160), seed=0)
    DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: records)
    MetadataCatalog.get(name).update(evaluator_type="voc_records", thing_classes=["a", "b", "c"])
    saved = []
    monkeypatch.setattr(checkpoint.Checkpointer, "save", lambda self, state, it: saved.append(it))
    cfg = load_cfg()
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.SEED = 0
    cfg.DATASETS.TRAIN, cfg.DATASETS.TEST = (name,), ()
    cfg.SOLVER.IMS_PER_BATCH, cfg.SOLVER.MAX_ITER = 1, 2
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN = (96,), 160
    cfg.TPU.TRAIN_BUCKET = (128, 160)
    try:
        state = train_loop.do_train(cfg, device="cpu")
    finally:
        DatasetCatalog.remove(name)
    assert state.step == 2 and saved[-1] == 2
    assert isinstance(state.model.backbone, EVA02SimpleFPN) and state.model.backbone.branch_rates[-1] == 0.4
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    losses = [line["total_loss"] for line in lines if "total_loss" in line]
    assert [line["iteration"] for line in lines if "total_loss" in line] == [1, 2]
    assert all(np.isfinite(losses))


@pytest.mark.cuda
def test_graphs_on_the_card():
    """The small EVA-02 detector on the card at batch 2: four calls, each
    bitwise the eager path, the trunk captured as a graph of its own (its
    mark between the same stages on the eager, capturing and replaying
    calls), and the counters counted on the eager and capturing calls and
    the eager ``raw`` calls only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    cfg = load_cfg()
    dev = torch.device("cuda", 0)
    p = Predictor(cfg, dev, state_dict=build_model(ModelSpec.from_cfg(cfg), "cpu", seed=3).state_dict())
    tracing.enable()
    try:
        for r in range(4):
            images, hw = images_and_sizes(2, 256, 384, seed=10 + r)
            marks = []
            out = p(images, hw, mark=marks.append)
            want = p.cascade(p.raw(images, hw))
            assert marks == STAGES + ["cascade"], r
            for name in want._fields:
                assert torch.equal(getattr(out, name), getattr(want, name)), (r, name)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
    kinds = ("predict.eager", "predict.graph.capture", "predict.graph.replay")
    assert {kind: counters.get(kind, 0) for kind in kinds} == dict(zip(kinds, (1, 1, 2)))
    graphs = next(iter(p._graphs.values()))
    assert [name for name, _ in graphs.graphs] == STAGES + ["cascade"]
    want = hand_counts(2, 16, 24)
    assert {k: counters[k] for k in COUNTERS} == {k: 6 * v for k, v in want.items()}
