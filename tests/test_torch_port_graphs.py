"""``Predictor.__call__`` as CUDA graphs per input shape
(``openset_rcnn_tpu_torch/evaluation/inference.py``): on the card, graph
and eager outputs are bitwise equal, replays launch the port's kernels
without calling their wrappers, the call counts read one eager call,
one capture, then replays, outputs survive later calls, weights loaded in
place reach the graphs and moved ones drop them, and shapes past the bound
run eagerly; on the CPU and in train mode, every call runs eagerly.

Imports nothing of the JAX package, so the tests marked ``cuda`` run on a
machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_graphs.py
"""
from pathlib import Path

import pytest
import torch

from openset_rcnn_tpu_torch.config import get_default_cfg
from openset_rcnn_tpu_torch.evaluation.inference import GRAPH_SHAPES, Predictor
from openset_rcnn_tpu_torch.models.serving import ServeDetections
from openset_rcnn_tpu_torch.ops.nms import nms_keep
from openset_rcnn_tpu_torch.ops.roi_align import roi_align
from openset_rcnn_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {
    "r50_bf16": ROOT / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml",
    "r50_f32": ROOT / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml",
    "vit_b": ROOT / "configs/VOC-COCO/openset_rcnn_ViT_FPN_128k.yaml",
    "swin_t": ROOT / "configs/VOC-COCO/openset_rcnn_SwinT_FPN_128k.yaml",
}
STAGES = ["backbone", "rpn", "roi_align", "heads", "cascade"]
SWIN_STAGES = ["backbone.res2", "backbone.res3", "backbone.res4", "backbone.res5"] + STAGES  # Swin's own first
EAGER, CAPTURE, REPLAY = "predict.eager", "predict.graph.capture", "predict.graph.replay"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    yield
    tracing.disable()


def load_cfg(name):
    cfg = get_default_cfg()
    cfg.merge_from_file(str(CONFIGS[name]))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0  # proposals of positive size from a random init
    return cfg


def inputs(B, bucket, seed, device="cpu"):
    """(B, H, W, 3) uint8 pixels padded with 0 beyond each image's (h, w),
    and the (B, 2) f32 sizes, as the loader gives them."""
    g = torch.Generator().manual_seed(seed)
    H, W = bucket
    hw = torch.tensor([[H - 24 * i - seed % 7, W - 40 * i - seed % 5] for i in range(B)], dtype=torch.float32)
    images = torch.randint(0, 256, (B, H, W, 3), generator=g, dtype=torch.uint8)
    for i, (h, w) in enumerate(hw.long().tolist()):
        images[i, h:] = 0
        images[i, :, w:] = 0
    return images.to(device), hw


def eager(p, images, image_hw):
    """Today's path: the forward, then the cascade."""
    return p.cascade(p.raw(images, image_hw))


def assert_equal(got, want, what=""):
    for name in ServeDetections._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), f"{what} {name}"


def clone(out):
    return ServeDetections(*(t.clone() for t in out))


@pytest.mark.cuda
@pytest.mark.parametrize("with_mark", [False, True])
@pytest.mark.parametrize("config, batch, buckets, on_device", [
    ("r50_bf16", 1, [(832, 1344)], False),
    ("r50_bf16", 1, [(832, 1344), (1344, 832)], False),
    ("vit_b", 2, [(256, 384)], True),
    ("swin_t", 1, [(832, 1344)], False),
    ("r50_f32", 8, [(832, 1344)], False),
])
def test_graphs_match_eager_bitwise(dev, config, batch, buckets, on_device, with_mark):
    """Four rounds over the buckets, new pixels each round: every call's
    outputs bitwise equal eager ``raw`` + ``cascade`` on the same inputs,
    still after every later call; the counts read one eager call and one
    capture per bucket, then replays; the marks fall between the same
    stages on every path; K1's and K4's wrappers launch on the eager and
    the capturing call of a bucket, and a replay calls neither."""
    p = Predictor(load_cfg(config), dev, seed=0)
    kept = []
    for r in range(4):
        for bucket in buckets:
            images, image_hw = inputs(batch, bucket, seed=10 * r + len(kept), device=dev if on_device else "cpu")
            marks = []
            before = (roi_align.launches, nms_keep.launches)
            out = p(images, image_hw, mark=marks.append if with_mark else None)
            launched = (1, 2) if r < 2 else (0, 0)
            assert (roi_align.launches - before[0], nms_keep.launches - before[1]) == launched
            assert marks == ((SWIN_STAGES if config == "swin_t" else STAGES) if with_mark else [])
            want = eager(p, images, image_hw)
            assert_equal(out, want, f"round {r} bucket {bucket}")
            kept.append((out, clone(want)))
    n = len(buckets)
    assert p.counts == {EAGER: n, CAPTURE: n, REPLAY: 2 * n}
    for i, (out, want) in enumerate(kept):
        assert_equal(out, want, f"call {i} after the later calls")
    assert any(bool(want.valid.any()) for _, want in kept)


@pytest.mark.cuda
def test_replays_launch_the_port_kernels(dev):
    """The device trace of three replays holds K1's kernel three times and
    each of K4's two passes six times (the cascade's two NMS calls a batch),
    though no replay calls a wrapper: their launch counters stay put."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p = Predictor(load_cfg("r50_bf16"), dev, seed=0)
    images, image_hw = inputs(1, (256, 384), seed=0)
    for _ in range(2):
        p(images, image_hw)
    torch.cuda.synchronize()
    before = (roi_align.launches, nms_keep.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            p(images, image_hw)
        torch.cuda.synchronize()
    assert (roi_align.launches, nms_keep.launches) == before
    assert p.counts == {EAGER: 1, CAPTURE: 1, REPLAY: 3}
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = ("roi_align_fwd_kernel", "nms_iou_mask_kernel", "nms_walk_kernel")
    assert {k: sum(e.count for e in events if k in e.key) for k in kernels} == dict(zip(kernels, (3, 6, 6)))


@pytest.mark.cuda
def test_weights_loaded_in_place_reach_the_graphs(dev):
    """``load_state_dict`` after a capture: the next call replays and gives
    what eager gives with the new weights. Loaded with ``assign=True``
    (new tensors elsewhere), the graphs are dropped: one eager call, then a
    capture again."""
    cfg = load_cfg("r50_bf16")
    p = Predictor(cfg, dev, seed=0)
    images, image_hw = inputs(1, (832, 1344), seed=3)
    for _ in range(3):
        before = p(images, image_hw)
    other = Predictor(cfg, dev, seed=1).model.state_dict()
    p.model.load_state_dict(other)
    got = p(images, image_hw)
    assert p.counts == {EAGER: 1, CAPTURE: 1, REPLAY: 2}
    assert_equal(got, eager(p, images, image_hw), "after load_state_dict")
    assert not torch.equal(got.scores, before.scores)
    p.model.load_state_dict({k: v.clone() for k, v in Predictor(cfg, dev, seed=2).model.state_dict().items()},
                            assign=True)
    for kind in (EAGER, CAPTURE, REPLAY):
        counts = dict(p.counts)
        got = p(images, image_hw)
        counts[kind] += 1
        assert p.counts == counts
        assert_equal(got, eager(p, images, image_hw), f"after assign, {kind}")


@pytest.mark.cuda
def test_shapes_past_the_bound_run_eagerly(dev):
    """``GRAPH_SHAPES`` shapes get graphs; a further one runs eagerly on
    every call, with the same outputs."""
    p = Predictor(load_cfg("r50_bf16"), dev, seed=0)
    buckets = [(64 + 32 * i, 96 + 32 * i) for i in range(GRAPH_SHAPES + 1)]
    for _ in range(3):
        for i, bucket in enumerate(buckets):
            images, image_hw = inputs(1, bucket, seed=i)
            assert_equal(p(images, image_hw), eager(p, images, image_hw), f"bucket {bucket}")
    assert p.counts == {EAGER: GRAPH_SHAPES + 3, CAPTURE: GRAPH_SHAPES, REPLAY: GRAPH_SHAPES}


@pytest.mark.cuda
def test_train_mode_runs_eagerly_on_the_card(dev):
    """With the model in train mode, no call captures; back in eval mode,
    the shape is warmed up, captured and replayed as usual."""
    p = Predictor(load_cfg("r50_bf16"), dev, seed=0)
    images, image_hw = inputs(1, (128, 192), seed=0)
    p.model.train()
    for _ in range(3):
        assert_equal(p(images, image_hw), eager(p, images, image_hw), "train mode")
    assert p.counts == {EAGER: 3, CAPTURE: 0, REPLAY: 0}
    p.model.eval()
    for _ in range(3):
        assert_equal(p(images, image_hw), eager(p, images, image_hw), "eval mode")
    assert p.counts == {EAGER: 4, CAPTURE: 1, REPLAY: 1}


@pytest.fixture(scope="module")
def cpu_predictor():
    return Predictor(load_cfg("r50_f32"), device="cpu", seed=0)


@pytest.mark.parametrize("train", [False, True])
def test_cpu_calls_run_eagerly(cpu_predictor, train):
    """On the CPU, in eval or train mode: every call runs eagerly, counts
    ``predict.eager`` on the Predictor and in the tracer, calls the marks
    as before, and returns today's outputs (``raw`` then ``cascade``)."""
    p = cpu_predictor
    p.model.train(train)
    try:
        images, image_hw = inputs(1, (64, 96), seed=1)
        want = eager(p, images, image_hw)
        counts = dict(p.counts)
        tracing.enable()
        for _ in range(3):
            marks = []
            assert_equal(p(images, image_hw, mark=marks.append), want, "cpu")
            assert marks == STAGES
        snap = tracing.snapshot()
        assert snap["counters"] == {EAGER: 3}
        assert p.counts == {EAGER: counts[EAGER] + 3, CAPTURE: 0, REPLAY: 0}
    finally:
        p.model.eval()
