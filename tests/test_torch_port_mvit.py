"""MViTv2 + FPN (``configs/VOC-COCO/openset_rcnn_MViTv2L_FPN_128k.yaml``) in
the port against the benchmark's plain reference, on the CPU at small sizes.

The reference (``perfbench/reference/models/mvit.py``) is an MViTv2 written
from detectron2's equations, independent of the port; both load one seeded
state dict, the relative-position tables drawn at std 0.02 (never zeros).

The small trunk: width 16, one head, blocks 0-7 with stage ends 1/3/5/7,
window 8, kv stride 4, relative-position size 8. On an 88 x 120 canvas
(22 x 30 tokens, no multiple of any window) it has every kind of block:
block 0 windowed with k and v pooled 4x (12 windows of 8 against 2),
block 2 a stage transition (q pooled 2x, width 16 -> 32, the max-pooled
shortcut), block 3 global with its tables resized (7 -> 21 and 29 rows, at
a non-integer q/k ratio 11/3), blocks 6-7 with windows of 1 and a 1-row
table.

* Each kind of block, the whole trunk (with and without residual pooling)
  and a small detector's raw outputs through ``Predictor`` (eager) against
  the reference; the trunk's gradients against the reference's autograd,
  with drop-path masks; every mask reaching its branch in call order.
* ``get_rel_pos`` against a direct loop; q and kv window counts agree.
* The counters ``mvit.q_tokens``, ``mvit.kv_tokens``, ``mvit.attn_logits``
  against a hand count; the marks and spans of an eager call.
* The L yaml: 212,484,384 trunk parameters, by the hand formula too, and one
  ``do_train`` step.
* On the card (``cuda``): the small detector's stage graphs bitwise the
  eager path, the pooling kernel launched once a block on the calls that
  run the wrappers.

Imports nothing of the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_mvit.py
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
from openset_rcnn_tpu_torch.models import mvit as port_mvit
from openset_rcnn_tpu_torch.models.detector import ModelSpec, OpensetRCNN, build_model, inference_stages
from openset_rcnn_tpu_torch.models.mvit import MViT, MViTConfig
from openset_rcnn_tpu_torch.models import vit
from openset_rcnn_tpu_torch.utils import tracing
from perfbench.reference import model as ref_model
from perfbench.reference.backbones import build_mvit_fpn_backbone
from perfbench.reference.models import detector as ref_det
from perfbench.reference.models import mvit as ref_mvit

ROOT = Path(__file__).resolve().parents[1]
MVIT_L = ROOT / "configs/VOC-COCO/openset_rcnn_MViTv2L_FPN_128k.yaml"
TOL = 1e-4
TRUNK = ["backbone.res2", "backbone.res3", "backbone.res4", "backbone.res5"]
STAGES = ["backbone", "rpn", "roi_align", "heads"]
SMALL = dict(EMBED_DIM=16, DEPTH=8, NUM_HEADS=1, LAST_BLOCK_INDEXES=[1, 3, 5, 7], ADAPTIVE_WINDOW_SIZE=8,
             PRETRAIN_SIZE=32)


@pytest.fixture(scope="module", autouse=True)
def share_cores():
    """Torch's threads as ``tests/port_threads.py`` sets them (set here: on
    the card this file runs without the repository's conftest)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(2, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def load_cfg(small=True, **mvit):
    cfg = get_default_cfg()
    cfg.merge_from_file(str(MVIT_L))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0  # proposals of positive size from a random init
    cfg.MODEL.MVIT.update({**(SMALL if small else {}), **mvit})
    return cfg


def small_trunks(seed=0, **mvit):
    """The port's small trunk from a seeded init and the reference's with
    its state dict."""
    cfg = load_cfg(**mvit)
    port = MViT(MViTConfig.from_cfg(cfg.MODEL.MVIT))
    port.reset_parameters(torch.Generator().manual_seed(seed))
    ref, widths = build_mvit_fpn_backbone.build(reference_cfg(cfg), torch.float32)
    assert widths == tuple(port.out_channels)
    ref.load_state_dict(port.state_dict(), strict=True)
    return port, ref


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


@pytest.mark.parametrize("block, grid, out_grid", [
    (0, (22, 30), (22, 30)),  # windowed, k and v pooled 4x
    (2, (22, 30), (11, 15)),  # stage transition: q pooled 2x, 16 -> 32, max-pooled shortcut
    (3, (11, 15), (11, 15)),  # global, tables resized
])
def test_blocks_match_the_reference(block, grid, out_grid):
    """One block of each kind on the same (B, H, W, C) input: the port's
    within 1e-4 of the reference's (scaled by max(1, max|want|)), with
    non-zero relative-position tables."""
    port, ref = small_trunks(seed=block)
    pb, rb = getattr(port, f"block{block}"), getattr(ref, f"block{block}")
    assert pb.attn.rel_pos_h.abs().min() > 0 and pb.attn.rel_pos_w.abs().min() > 0
    x = torch.randn(2, *grid, pb.spec.dim, generator=torch.Generator().manual_seed(10 + block))
    with torch.no_grad():
        got, want = pb(x), rb(x)
    assert tuple(got.shape) == (2, *out_grid, pb.spec.dim_out)
    assert_close(got, want, f"block{block}")


def test_block_kinds_of_the_small_trunk():
    """The small trunk's schedule has the kinds the tests above name."""
    specs = port_mvit.block_schedule(MViTConfig.from_cfg(load_cfg().MODEL.MVIT))
    s0, s2, s3, s6, s7 = specs[0], specs[2], specs[3], specs[6], specs[7]
    assert (s0.stride_q, s0.stride_kv, s0.window) == (1, 4, 8)
    assert (s2.dim, s2.dim_out, s2.stride_q, s2.window) == (16, 32, 2, 8)
    assert (s3.stride_kv, s3.window, s3.rel_size) == (4, 0, 4)
    assert (s6.window // s6.stride_q, s7.window, s7.rel_size) == (1, 0, 1)


@pytest.mark.parametrize("residual_pooling", [True, False])
def test_trunk_matches_the_reference(residual_pooling):
    """Every output of the small trunk on 88 x 120 within 1e-4 of the
    reference's: 22 x 30, 11 x 15, 6 x 8 and 3 x 4 tokens."""
    port, ref = small_trunks(seed=3, RESIDUAL_POOLING=residual_pooling)
    x = torch.randn(2, 3, 88, 120, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = port(x.contiguous(memory_format=torch.channels_last))
        want = ref.eval()(x)
    sides = {"res2": (22, 30), "res3": (11, 15), "res4": (6, 8), "res5": (3, 4)}
    assert set(got) == set(want) == set(sides)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape) == (2, 16 * 2 ** (int(k[3]) - 2), *sides[k]), k
        assert_close(got[k], v, k)


def test_detector_raw_outputs_match_the_reference():
    """The small MViT detector through ``Predictor.raw`` (eager) against the
    reference detector on 2 x 64 x 96: P2-P6 within 1e-4, the raw
    detections of every anchor as per-image multisets."""
    cfg = load_cfg()
    model = build_model(ModelSpec.from_cfg(cfg), "cpu", seed=0)
    assert model.backbone.out_channels == [16, 32, 64, 128]
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


def rel_pos_by_loop(table, q_size, k_size):
    """(q, k, d) by hand: linear interpolation of the rows (half-pixel
    sampling, the last row held) where the table has another number than
    2 * max(q, k) - 1, then each (i, j) offset's row; f32 arithmetic, as
    PyTorch computes both."""
    f = np.float32
    table = np.asarray(table, f)
    rows, n = table.shape[0], 2 * max(q_size, k_size) - 1
    if rows != n:
        out = np.empty((n, table.shape[1]), f)
        scale = f(rows) / f(n)
        for r in range(n):
            src = max(f(scale * f(f(r) + f(0.5))) - f(0.5), f(0.0))
            lo = min(int(math.floor(src)), rows - 1)
            hi, t = min(lo + 1, rows - 1), f(src - f(lo))
            out[r] = (f(1) - t) * table[lo] + t * table[hi]
        table = out
    rq, rk = f(max(k_size / q_size, 1.0)), f(max(q_size / k_size, 1.0))
    idx = np.array([[int(f(f(f(i) * rq) - f(f(j) * rk)) + f(f(k_size - 1) * rk)) for j in range(k_size)]
                    for i in range(q_size)])
    return table[idx]


@pytest.mark.parametrize("q_size, k_size, rows", [(7, 7, 13), (56, 14, 111), (28, 14, 55), (11, 3, 7),
                                                  (3, 11, 7), (104, 26, 55), (5, 5, 1)])
def test_get_rel_pos_against_a_loop(q_size, k_size, rows):
    """The port's ``get_rel_pos`` and the reference's, each against a direct
    loop, on tables kept (13, 111, 55 rows) and resized: within 1e-5 on
    unit-scale tables (PyTorch's interpolation rounds its weights apart from
    the loop's; a wrong row or weight is off by a tenth or more)."""
    table = torch.randn(rows, 6, generator=torch.Generator().manual_seed(q_size * 100 + k_size))
    want = rel_pos_by_loop(table.numpy(), q_size, k_size)
    got = port_mvit.get_rel_pos(table, port_mvit.rel_pos_index(q_size, k_size))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ref_mvit.get_rel_pos(q_size, k_size, table).numpy(), want, rtol=0, atol=1e-5)


def test_window_counts_agree():
    """Every windowed block of the L schedule cuts its pooled q grid and its
    pooled kv grid into the same number of windows, ceil(side / window) a
    side, at every side up to 2 * 56 + 1 of the block's input grid."""
    specs = port_mvit.block_schedule(MViTConfig.from_cfg(load_cfg(small=False).MODEL.MVIT))
    kinds = {(s.stride_q, s.stride_kv, s.window) for s in specs if s.window}
    assert kinds == {(1, 4, 56), (2, 2, 56), (1, 2, 28), (2, 1, 28), (1, 1, 14), (2, 1, 14), (1, 1, 7)}
    for sq, skv, w in kinds:
        for n in range(1, 2 * 56 + 2):
            q = -(-port_mvit.pooled_side(n, 3, sq) // (w // sq))
            kv = -(-port_mvit.pooled_side(n, 3, skv) // (w // skv))
            assert q == kv == -(-n // w), (sq, skv, w, n)


def test_window_partitions_agree_in_the_block(monkeypatch):
    """At a grid that pads, the block's own partitions of q and kv (inside
    its pooling operator, ``ops/mvit_pool.py``, which calls
    ``models/vit.py``'s) give the same number of windows (the block raises
    where they would not)."""
    port, _ = small_trunks()
    seen = []
    real = vit._window_partition

    def spy(x, w):
        out = real(x, w)
        seen.append(out[0].shape[0])
        return out

    monkeypatch.setattr(vit, "_window_partition", spy)
    with torch.no_grad():
        port.block0(torch.randn(1, 23, 29, 16))
    assert seen == [12, 12, 12]  # 3 x 4 windows of q (8), of k and of v (2)


def hand_counts(B, H, W):
    """(q tokens, kv tokens, logits) of the small trunk per stage, on an
    H x W canvas, counted block by block from the table of grids."""
    g = (H // 4, W // 4)
    side = lambda n, s: -(-n // s)  # noqa: E731
    out = []
    # per block: (stride_q, stride_kv, q window, kv window (0: global), heads)
    stages = [[(1, 4, 8, 2, 1), (1, 4, 8, 2, 1)],
              [(2, 2, 4, 4, 2), (1, 4, 0, 0, 2)],
              [(2, 1, 2, 4, 4), (1, 2, 0, 0, 4)],
              [(2, 1, 1, 2, 8), (1, 1, 0, 0, 8)]]
    for blocks in stages:
        q_tok = kv_tok = logits = 0
        for sq, skv, wq, wk, heads in blocks:
            qh, qw = side(g[0], sq), side(g[1], sq)
            kh, kw = side(g[0], skv), side(g[1], skv)
            q_tok += qh * qw
            kv_tok += kh * kw
            logits += heads * (side(qh, wq) * side(qw, wq) * wq * wq * wk * wk if wq else qh * qw * kh * kw)
            g = (qh, qw)
        out.append((B * q_tok, B * kv_tok, B * logits))
    return out


def test_eager_marks_spans_and_counters():
    """One eager ``Predictor`` call on the CPU (64 x 96, batch 2: 16 x 24,
    8 x 12, 4 x 6, 2 x 3 tokens): the marks in stage order, MViT's four
    stages as host spans inside ``predict``, and the counters as counted by
    hand."""
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
    assert marks == TRUNK + STAGES + ["cascade"]
    counts = hand_counts(2, 64, 96)
    # stage 1: two blocks of 16 x 24 queries (2 x 3 windows of 8 x 8 against 2 x 2 keys)
    assert counts[0] == (2 * 2 * 384, 2 * 2 * 24, 2 * 2 * 6 * 64 * 4)
    want = {name: sum(c[i] for c in counts)
            for i, name in enumerate(("mvit.q_tokens", "mvit.kv_tokens", "mvit.attn_logits"))}
    assert snap["counters"] == {"predict.eager": 1, **want}
    (predict,) = [s for s in snap["spans"] if s["name"] == "predict"]
    stages = [s for s in snap["spans"] if s["name"].startswith("stage.")]
    assert [s["name"] for s in stages] == ["stage." + m for m in TRUNK]
    assert all(s["parent"] == predict["id"] for s in stages)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(stages, stages[1:]))


def test_stage_list():
    """MViT's four stages come before the FPN's "backbone"."""
    with torch.device("meta"):
        model = OpensetRCNN(ModelSpec.from_cfg(load_cfg(small=False)))
    assert [name for name, _ in inference_stages(model, None, [])] == TRUNK + STAGES


def param_count(c: MViTConfig) -> int:
    """The trunk's parameters by hand from the schedule."""
    k2 = c.qkv_pool_kernel ** 2
    n = 3 * 49 * c.embed_dim + c.embed_dim  # patch embedding, 7 x 7 with a bias
    for s in port_mvit.block_schedule(c):
        d, hidden = s.dim_out // s.num_heads, int(s.dim_out * c.mlp_ratio)
        rows = 2 * max(s.rel_size // s.stride_q, s.rel_size // s.stride_kv) - 1
        n += 2 * s.dim + 2 * s.dim_out  # norm1, norm2
        n += s.dim * 3 * s.dim_out + 3 * s.dim_out  # qkv
        n += 3 * (d * k2 + 2 * d)  # the pooling convolutions and their norms
        n += 2 * rows * d  # rel_pos_h, rel_pos_w
        n += s.dim_out * s.dim_out + s.dim_out  # attn.proj
        n += s.dim * s.dim_out + s.dim_out if s.dim != s.dim_out else 0  # the shortcut's Linear
        n += 2 * s.dim_out * hidden + hidden + s.dim_out  # the MLP
    return n + sum(2 * c.embed_dim * 2 ** s for s in range(4))  # the output norms


def test_l_yaml_builds_the_published_trunk():
    """The L yaml's trunk: 212,484,384 parameters (the hand formula's count;
    MViTv2-T and -B by the same formula: 23.4 M and 50.7 M, the paper's 24 M
    and 51 M less the classification head), widths 144..1152, heads 2..16,
    the global blocks' tables of 55 rows."""
    spec = ModelSpec.from_cfg(load_cfg(small=False))
    assert spec.mvit == MViTConfig(144, 48, 2, (1, 7, 43, 47), 3, 4, 56, True, 4.0, 224, 0.5)
    with torch.device("meta"):
        model = OpensetRCNN(spec)
    trunk = model.backbone
    assert sum(p.numel() for p in trunk.parameters()) == param_count(spec.mvit) == 212_484_384
    assert param_count(MViTConfig()) == 23_405_664
    assert param_count(MViTConfig(96, 24, 1, (1, 4, 20, 23))) == 50_705_088
    assert trunk.out_channels == [144, 288, 576, 1152]
    assert [getattr(trunk, f"block{i}").spec.num_heads for i in (0, 7, 43, 47)] == [2, 4, 8, 16]
    assert trunk.block7.attn.rel_pos_h.shape == (55, 72) and trunk.block47.attn.rel_pos_w.shape == (13, 72)
    assert len(trunk.branch_rates) == 96 and trunk.branch_rates[-1] == 0.5


def test_trunk_gradients_match_the_reference():
    """The small trunk's loss (a fixed weighting of its four outputs) and
    every parameter's gradient, with drop-path masks at rate 0.5, against
    the reference's autograd: within 1e-4 of each tensor's largest, or of a
    thousandth of the trunk's largest where a gradient cancels to rounding
    noise (the keys' LayerNorm bias: softmax ignores a shift of every key
    where no window pads)."""
    port, ref = small_trunks(seed=5, DROP_PATH_RATE=0.5)
    port.train()
    ref.train()
    x = torch.randn(2, 3, 88, 120, generator=torch.Generator().manual_seed(6))
    g = torch.Generator().manual_seed(7)
    masks = port_det.drop_path_masks(port.branch_rates, 2, g, torch.device("cpu"))
    assert not masks.all() and masks.any()
    weights = {k: torch.randn(2, 16 * 2 ** i, *side, generator=g)
               for i, (k, side) in enumerate({"res2": (22, 30), "res3": (11, 15), "res4": (6, 8),
                                              "res5": (3, 4)}.items())}
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


def test_drop_path_masks_reach_every_branch_in_call_order(monkeypatch):
    """Each block's attention branch takes row 2i of the masks and its MLP
    branch row 2i + 1, in call order, at the block's rate."""
    port, _ = small_trunks(DROP_PATH_RATE=0.5)
    seen = []
    real = port_mvit.drop_path

    def spy(y, keep, rate):
        seen.append((keep.data_ptr() if keep is not None else None, rate))
        return real(y, keep, rate)

    monkeypatch.setattr(port_mvit, "drop_path", spy)
    masks = torch.ones(16, 2, dtype=torch.bool)
    with torch.no_grad():
        port(torch.randn(2, 3, 64, 96), drop_path=masks)
    assert seen == [(masks[i].data_ptr(), port.branch_rates[i]) for i in range(16)]
    assert port.branch_rates[::2] == pytest.approx([0.5 * i / 7 for i in range(8)], rel=1e-12)


def test_do_train_builds_the_l_yaml(tmp_path, monkeypatch):
    """``do_train`` on the L yaml (one step at batch 1 on a 128 x 160 bucket
    of synthetic images, drop-path 0.5 drawn): it builds the published trunk
    and steps it to a finite loss. The final checkpoint is recorded, not
    written (the trunk alone is 850 MB)."""
    from openset_rcnn_tpu_torch.data import DatasetCatalog, MetadataCatalog, generate_synthetic_dataset
    from openset_rcnn_tpu_torch.engine import checkpoint, train_loop

    name = "port_mvit_train"
    records = generate_synthetic_dataset(str(tmp_path / "train"), num_images=2, image_hw=(120, 160), seed=0)
    DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: records)
    MetadataCatalog.get(name).update(evaluator_type="voc_records", thing_classes=["a", "b", "c"])
    saved = []
    monkeypatch.setattr(checkpoint.Checkpointer, "save", lambda self, state, it: saved.append((state, it)))
    cfg = load_cfg(small=False)
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.SEED = 0
    cfg.DATASETS.TRAIN, cfg.DATASETS.TEST = (name,), ()
    cfg.SOLVER.IMS_PER_BATCH, cfg.SOLVER.MAX_ITER = 1, 1
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN = (96,), 160
    cfg.TPU.TRAIN_BUCKET = (128, 160)
    try:
        state = train_loop.do_train(cfg, device="cpu")
    finally:
        DatasetCatalog.remove(name)
    assert state.step == 1 and [it for _, it in saved] == [1]
    assert sum(p.numel() for p in state.model.backbone.parameters()) == 212_484_384
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
        line = json.loads(f.readline())
    assert line["iteration"] == 1 and np.isfinite(line["total_loss"])


@pytest.mark.cuda
def test_graphs_on_the_card():
    """The small MViT detector on the card at batch 2: four calls, each
    bitwise the eager path, the marks between the same stages on the eager,
    capturing and replaying calls, and the counters counted on the eager
    and capturing calls and the eager ``raw`` calls only: the pooling
    kernel's launches too, once a block (8) a call that runs the wrappers."""
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
            assert marks == TRUNK + STAGES + ["cascade"], r
            for name in want._fields:
                assert torch.equal(getattr(out, name), getattr(want, name)), (r, name)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
    kinds = ("predict.eager", "predict.graph.capture", "predict.graph.replay")
    assert {kind: counters.get(kind, 0) for kind in kinds} == dict(zip(kinds, (1, 1, 2)))
    q = sum(c[0] for c in hand_counts(2, 256, 384))
    assert counters["mvit.q_tokens"] == 6 * q
    assert counters["kernel.mvit_pool_norm"] == 6 * 8
