"""MViT's attention pooling operator ``openset_rcnn::mvit_pool_norm``
(``ops/mvit_pool.py``).

On the CPU: its route there is the pooling-attention block's former
composition (the split of the qkv Linear's output, the ``pool_*``
convolutions, the ``norm_*`` LayerNorms, ``_window_partition``) bit for bit,
for every (stride_q, stride_kv, window) kind of MViTv2-L's schedule, at grids
that pad and grids that do not; its registered backward gives autograd's
gradients through that composition; the CUDA implementation raises on what
the kernel does not take, a CPU tensor included (no fallback); the fake
implementation's shapes; a trunk forward calls the operator once a block.

On the card (``cuda``): ``csrc/mvit_pool_norm.cu`` against the plain version
at every distinct block shape of MViTv2-L at 832x1344 and at a grid that
pads, at head widths 16, 64, 72, 96 and others, padded window rows exactly
0, two launches and a graph replay bitwise the eager call, what it rejects,
and its launches by trunk. Imports nothing of the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_mvit_pool.py
"""
import collections
import contextlib
from pathlib import Path

import pytest
import torch

from openset_rcnn_tpu_torch.models import mvit as port_mvit
from openset_rcnn_tpu_torch.models import vit
from openset_rcnn_tpu_torch.models.mvit import BlockSpec, MultiScaleAttention, MViTConfig
from openset_rcnn_tpu_torch.ops import mvit_pool
from openset_rcnn_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
MVIT_L = MViTConfig(144, 48, 2, (1, 7, 43, 47), 3, 4, 56, True, 4.0, 224, 0.5)
# (stride_q, stride_kv, window) of MViTv2-L's blocks; window 0: global
L_KINDS = [(1, 4, 56), (2, 2, 56), (1, 2, 28), (2, 1, 28), (1, 1, 14), (2, 1, 14), (1, 1, 7),
           (1, 4, 0), (1, 2, 0), (1, 1, 0)]
# every distinct pooling call of MViTv2-L at 832x1344: (H, W, heads, d, stride_q, stride_kv, q window, kv
# window) and its blocks
L_CALLS_832 = {
    (208, 336, 2, 72, 1, 4, 56, 14): 2, (208, 336, 4, 72, 2, 2, 28, 28): 1, (104, 168, 4, 72, 1, 2, 28, 14): 4,
    (104, 168, 4, 72, 1, 4, 0, 0): 1, (104, 168, 8, 72, 2, 1, 14, 28): 1, (52, 84, 8, 72, 1, 1, 14, 14): 34,
    (52, 84, 8, 72, 1, 2, 0, 0): 1, (52, 84, 16, 72, 2, 1, 7, 14): 1, (26, 42, 16, 72, 1, 1, 7, 7): 2,
    (26, 42, 16, 72, 1, 1, 0, 0): 1,
}
# kernel against plain on the card: 9-tap sums and the norm's statistics in
# another order than cuDNN's and PyTorch's, each f32; scaled by
# max(1, max|want|) (a wrong tap or channel is off by a tenth or more)
CARD_TOL = 2e-5


def l_calls(H, W):
    """{(H, W, heads, d, stride_q, stride_kv, q window, kv window): blocks}
    of MViTv2-L on an H x W token grid, block by block."""
    calls = collections.Counter()
    for s in port_mvit.block_schedule(MVIT_L):
        wq, wk = (s.window // s.stride_q, s.window // s.stride_kv) if s.window else (0, 0)
        calls[(H, W, s.num_heads, s.dim_out // s.num_heads, s.stride_q, s.stride_kv, wq, wk)] += 1
        H, W = port_mvit.pooled_side(H, 3, s.stride_q), port_mvit.pooled_side(W, 3, s.stride_q)
    return dict(calls)


def attention(kind, d=8, heads=2, seed=0):
    """A pooling-attention module of ``kind`` (stride_q, stride_kv, window)
    with random pooling weights and norms (scale around 1, bias around 0)."""
    sq, skv, window = kind
    attn = MultiScaleAttention(BlockSpec(heads * d, heads * d, heads, sq, skv, window, 8), 3, True)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in "qkv":
            getattr(attn, f"pool_{name}").weight.normal_(0, 0.3, generator=g)
            getattr(attn, f"norm_{name}").scale.uniform_(0.5, 1.5, generator=g)
            getattr(attn, f"norm_{name}").bias.normal_(0, 0.1, generator=g)
    return attn


def former(qkv, attn):
    """The block's former composition, op for op: the split, then per tensor
    its convolution module, its LayerNorm module and, windowed,
    ``_window_partition``, then the (N, tokens, d) view."""
    B, H, W, _ = qkv.shape
    h = attn.num_heads
    x = qkv.reshape(B, H, W, 3, h, -1).permute(3, 0, 4, 1, 2, 5).reshape(3, B * h, H, W, -1)
    out = []
    for t, name in zip(x, "qkv"):
        y = getattr(attn, f"pool_{name}")(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = getattr(attn, f"norm_{name}")(y)
        window = attn.q_window if name == "q" else attn.kv_window
        if window:
            y, _ = vit._window_partition(y, window)
        out.append(y.reshape(y.shape[0], -1, y.shape[-1]))
    return out


def grid(kind, pad):
    """A token grid on which the pooled grids are whole windows (``pad``
    False) or are padded; global kinds: two grids of odd sides."""
    window = kind[2]
    if not window:
        return (13, 17) if pad else (9, 24)
    return (window + 3, 2 * window - 5) if pad else (window, 2 * window)


def test_l_kinds_and_calls_are_the_schedules():
    specs = port_mvit.block_schedule(MVIT_L)
    assert {(s.stride_q, s.stride_kv, s.window) for s in specs} == set(L_KINDS)
    assert l_calls(208, 336) == L_CALLS_832 and sum(L_CALLS_832.values()) == 48


@pytest.mark.parametrize("pad", [False, True], ids=["whole", "pads"])
@pytest.mark.parametrize("kind", L_KINDS, ids=lambda k: "q{}_kv{}_w{}".format(*k))
def test_cpu_route_is_the_former_composition(kind, pad):
    """q, k and v through the operator on the CPU equal the former
    composition bit for bit (shape, strides' contents and values), and the
    padded window rows are zeros."""
    attn = attention(kind)
    H, W = grid(kind, pad)
    qkv = torch.randn(2, H, W, attn.qkv.out_features, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = mvit_pool.mvit_pool_norm(qkv, attn)
        want = former(qkv, attn)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and torch.equal(g, w), name
    sq, skv, window = kind
    if window:
        side = lambda n, s: port_mvit.pooled_side(n, 3, s)  # noqa: E731
        wq = window // sq
        padded = (-(-side(H, sq) // wq) * wq, -(-side(W, sq) // wq) * wq) != (side(H, sq), side(W, sq))
        assert padded == pad
        zero_rows = (got[0].abs().amax(-1) == 0).sum()
        assert (zero_rows > 0) == pad


@pytest.mark.parametrize("kind", [(1, 4, 56), (2, 1, 14), (1, 2, 0)], ids=lambda k: "q{}_kv{}_w{}".format(*k))
def test_backward_is_autograd_through_the_former_composition(kind):
    """The gradients of qkv, the three pooling weights and the three norms'
    scales and biases, under a random weighting of q, k and v, equal what
    autograd gives through the former composition, bit for bit."""
    attn = attention(kind, seed=2)
    H, W = grid(kind, pad=True)
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, H, W, attn.qkv.out_features, generator=g)
    params = [getattr(attn, f"pool_{n}").weight for n in "qkv"]
    params += [getattr(getattr(attn, f"norm_{n}"), a) for n in "qkv" for a in ("scale", "bias")]
    grads = {}
    for route, fn in (("operator", mvit_pool.mvit_pool_norm), ("former", former)):
        x = qkv.clone().requires_grad_(True)
        attn.zero_grad()
        outs = fn(x, attn)
        weights = [torch.randn(o.shape, generator=torch.Generator().manual_seed(4 + i)) for i, o in enumerate(outs)]
        sum((o * w).sum() for o, w in zip(outs, weights)).backward()
        grads[route] = [x.grad] + [p.grad.clone() for p in params]
    for i, (got, want) in enumerate(zip(grads["operator"], grads["former"])):
        assert got is not None and torch.equal(got, want), i


def test_backward_of_one_output_and_no_input_gradient():
    """A loss on k alone: the gradients flow to qkv and k's weights, q's
    and v's weights get zeros, as through the former composition; an input
    that needs no gradient gets none."""
    attn = attention((1, 2, 28), seed=5)
    qkv = torch.randn(1, 31, 29, 3 * 16, generator=torch.Generator().manual_seed(6)).requires_grad_(True)
    attn.zero_grad()
    _, k, _ = mvit_pool.mvit_pool_norm(qkv, attn)
    k.sum().backward()
    got = (qkv.grad, attn.pool_k.weight.grad, attn.pool_q.weight.grad)
    x = qkv.detach().clone().requires_grad_(True)
    attn.zero_grad()
    former(x, attn)[1].sum().backward()
    assert torch.equal(got[0], x.grad) and torch.equal(got[1], attn.pool_k.weight.grad)
    assert got[2] is None or not got[2].any()
    with torch.no_grad():
        frozen = mvit_pool.mvit_pool_norm(qkv.detach(), attn)
    assert all(not t.requires_grad for t in frozen)


@pytest.mark.parametrize("d", [6, 2, 260, 258])
def test_the_cuda_route_raises_on_head_widths_it_does_not_take(d):
    """Head widths no multiple of 4, or above 256: ``ValueError`` before any
    launch."""
    attn = attention((1, 1, 0), d=d, heads=1)
    qkv = torch.zeros(1, 5, 5, 3 * d)
    with pytest.raises(ValueError, match="head widths"):
        mvit_pool._mvit_pool_norm_cuda(*op_args(qkv, attn))


def op_args(qkv, attn):
    a = attn
    return (qkv, a.pool_q.weight, a.pool_k.weight, a.pool_v.weight, a.norm_q.scale, a.norm_q.bias, a.norm_k.scale,
            a.norm_k.bias, a.norm_v.scale, a.norm_v.bias, a.num_heads, a.stride_q, a.stride_kv, a.q_window,
            a.kv_window, float(a.norm_q.eps))


def test_the_cuda_route_raises_on_what_else_it_does_not_take():
    """A head width the kernel takes, but a CPU tensor (no fallback to the
    plain version), bf16, a 5x5 pooling kernel, stride 5 or one window of
    two 0: ``ValueError``."""
    attn = attention((1, 1, 7), d=72, heads=1)
    qkv = torch.zeros(1, 14, 14, 3 * 72)
    with pytest.raises(ValueError, match="CUDA"):
        mvit_pool._mvit_pool_norm_cuda(*op_args(qkv, attn))
    with pytest.raises(ValueError, match="float32"):
        mvit_pool._mvit_pool_norm_cuda(*op_args(qkv.bfloat16(), attn))
    args = list(op_args(qkv, attn))
    for i, value in ((1, torch.zeros(72, 1, 5, 5)), (11, 5), (14, 0)):
        bad = list(args)
        bad[i] = value
        with pytest.raises(ValueError):
            mvit_pool._mvit_pool_norm_cuda(*bad)


@pytest.mark.parametrize("kind", [(1, 4, 56), (2, 1, 14), (1, 2, 0)], ids=lambda k: "q{}_kv{}_w{}".format(*k))
def test_fake_implementation_gives_the_plain_shapes(kind):
    attn = attention(kind)
    H, W = grid(kind, pad=True)
    qkv = torch.randn(2, H, W, attn.qkv.out_features)
    with torch.no_grad():
        want = mvit_pool.mvit_pool_norm(qkv, attn)
        meta = attn.to("meta")
        got = mvit_pool.mvit_pool_norm(qkv.to("meta"), meta)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert all(t.device.type == "meta" and t.dtype == torch.float32 for t in got)


def test_trunk_calls_the_operator_once_a_block(monkeypatch):
    """The small trunk (8 blocks) on the CPU: 8 calls, each of a block's own
    module and strides; the CPU route counts no launch."""
    cfg = dict(embed_dim=16, depth=8, num_heads=1, last_block_indexes=(1, 3, 5, 7), adaptive_window_size=8,
               pretrain_size=32)
    trunk = port_mvit.MViT(MViTConfig(**cfg))
    trunk.reset_parameters(torch.Generator().manual_seed(7))
    seen = []
    op = mvit_pool.mvit_pool_norm_op

    def recording(qkv, *args):
        seen.append((tuple(qkv.shape), args[9:14]))
        return op(qkv, *args)

    monkeypatch.setattr(mvit_pool, "mvit_pool_norm_op", recording)
    tracing.enable()
    try:
        with torch.no_grad():
            trunk(torch.randn(1, 3, 64, 96))
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
    specs = port_mvit.block_schedule(trunk.config)
    assert [s for _, s in seen] == [(s.num_heads, s.stride_q, s.stride_kv, getattr(trunk, f"block{i}").attn.q_window,
                                     getattr(trunk, f"block{i}").attn.kv_window) for i, s in enumerate(specs)]
    assert "kernel.mvit_pool_norm" not in counters


# ------------------------------------------------------------------ on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def launches():
    """The block's ``kernel.mvit_pool_norm`` launches, in the list it yields."""
    out = []
    tracing.enable()
    try:
        yield out
        out.append(tracing.snapshot()["counters"].get("kernel.mvit_pool_norm", 0))
    finally:
        tracing.disable()


def card_case(dev, call, B, seed):
    """(qkv, the operator's other arguments) of one pooling call on the card:
    a random Linear output and random weights and norms."""
    H, W, heads, d, sq, skv, wq, wk = call
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    u = lambda *s: torch.rand(*s, generator=g, device=dev)  # noqa: E731
    qkv = r(B, H, W, 3 * heads * d)
    weights = [r(d, 1, 3, 3) * 0.3 for _ in range(3)]
    norms = [t for _ in range(3) for t in (0.5 + u(d), r(d) * 0.1)]
    return qkv, (*weights, *norms, heads, sq, skv, wq, wk, 1e-6)


def padded_rows(call, B):
    """Per output, a bool (rows,) mask of the window rows beyond the pooled
    grid (None for a global output)."""
    H, W, heads, d, sq, skv, wq, wk = call
    out = []
    for stride, w in ((sq, wq), (skv, wk), (skv, wk)):
        if not w:
            out.append(None)
            continue
        h, wd = port_mvit.pooled_side(H, 3, stride), port_mvit.pooled_side(W, 3, stride)
        hp, wp = -(-h // w) * w, -(-wd // w) * w
        keep = torch.zeros(B * heads, hp, wp, dtype=torch.bool)
        keep[:, :h, :wd] = True
        out.append(~vit._window_partition(keep[..., None], w)[0].reshape(-1))
    return out


def check_against_plain(dev, call, B, seed):
    qkv, args = card_case(dev, call, B, seed)
    with launches() as n:
        got = torch.ops.openset_rcnn.mvit_pool_norm(qkv, *args)
        torch.cuda.synchronize()
    assert n == [1], call
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = mvit_pool.mvit_pool_norm_plain(qkv, *args)
    for name, g, w, pad in zip("qkv", got, want, padded_rows(call, B)):
        assert g.shape == w.shape and g.is_contiguous(), (call, name)
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= CARD_TOL * scale, (call, name, err)
        if pad is not None:
            rows = g.reshape(-1, d_of(call))[pad.to(dev)]
            assert rows.numel() == 0 or bool((rows.view(torch.int32) == 0).all()), (call, name)
    return got


def d_of(call):
    return call[3]


@pytest.mark.cuda
@pytest.mark.parametrize("canvas", [(832, 1344), (800, 1200)], ids=["832x1344", "800x1200_pads"])
def test_kernel_matches_plain_at_every_mvitv2_l_call(dev, canvas):
    """Every distinct pooling call of MViTv2-L on the canvas's token grid
    (208 x 336, or 200 x 300, where every windowed call pads), batch 2:
    within ``CARD_TOL`` of the plain version, padded window rows +0.0."""
    calls = l_calls(canvas[0] // 4, canvas[1] // 4)
    assert sum(calls.values()) == 48
    for i, call in enumerate(calls):
        check_against_plain(dev, call, 2, seed=i)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 72, 96, 4, 20, 128, 160, 200, 256])
def test_kernel_matches_plain_at_head_widths(dev, d):
    """Head widths of the test trunk (16), MViTv2-H (64), -L (72), -T/B (96)
    and others up to 256, at strides 1 to 4, windowed (padding) and
    global."""
    for i, (sq, skv, wq, wk) in enumerate([(1, 4, 8, 2), (2, 2, 4, 4), (2, 1, 3, 7), (1, 1, 0, 0), (1, 2, 0, 0),
                                           (3, 3, 2, 2), (2, 4, 0, 0)]):
        check_against_plain(dev, (27, 35, 2, d, sq, skv, wq, wk), 2, seed=100 + i)


@pytest.mark.cuda
def test_kernel_repeats_and_replays_bitwise(dev):
    """Two launches and a CUDA graph's replay of the stage-3 call equal the
    eager call bit for bit (no atomics)."""
    call = (52, 84, 8, 72, 1, 1, 14, 14)
    qkv, args = card_case(dev, call, 8, seed=7)
    op = torch.ops.openset_rcnn.mvit_pool_norm
    first, second = op(qkv, *args), op(qkv, *args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        op(qkv, *args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = op(qkv, *args)
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, captured):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(dev):
    call = (20, 24, 2, 72, 1, 2, 7, 7)
    qkv, args = card_case(dev, call, 1, seed=8)
    mvit_pool._mvit_pool_norm_cuda(qkv, *args)  # what it takes
    buf = torch.empty(qkv.numel() + 1, device=dev)
    bad = {
        "bf16": qkv.bfloat16(),
        "f64": qkv.double(),
        "strided": qkv[:, :, ::2],
        "misaligned": buf[1:].view(qkv.shape),
        "3-d": qkv[0],
    }
    for what, t in bad.items():
        with pytest.raises(ValueError):
            mvit_pool._mvit_pool_norm_cuda(t, *args)
        assert what
    for i, value in ((0, args[0][:8]), (0, args[0].double()), (0, args[0].cpu()), (3, args[3][:8]), (10, 5),
                     (13, 0)):
        wrong = list(args)
        wrong[i] = value
        with pytest.raises(ValueError):
            mvit_pool._mvit_pool_norm_cuda(qkv, *wrong)
    with pytest.raises(ValueError, match="head widths"):
        d = 70
        mvit_pool._mvit_pool_norm_cuda(torch.zeros(1, 8, 8, 3 * 2 * d, device=dev),
                                       *(torch.zeros(d, 1, 3, 3, device=dev),) * 3,
                                       *(torch.zeros(d, device=dev),) * 6, 2, 1, 1, 0, 0, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("config, want", [
    ("openset_rcnn_MViTv2L_FPN_128k.yaml", 48),
    ("openset_rcnn_R50_FPN_128k_tpu.yaml", 0),
    ("openset_rcnn_ViT_FPN_128k.yaml", 0),
    ("openset_rcnn_SwinB_FPN_128k.yaml", 0),
])
def test_launches_by_trunk(dev, config, want):
    """One eager pyramid forward on a 2 x 64 x 96 batch launches the kernel
    once a block on MViTv2-L (48) and never on the R50, ViT-B and Swin-B
    trunks."""
    from openset_rcnn_tpu_torch.config import get_default_cfg
    from openset_rcnn_tpu_torch.device import entry_numerics
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, build_model

    cfg = get_default_cfg()
    cfg.merge_from_file(str(ROOT / "configs/VOC-COCO" / config))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0
    model = build_model(ModelSpec.from_cfg(cfg), dev, seed=0)
    images = torch.tensor(cfg.MODEL.PIXEL_MEAN) + torch.rand(2, 64, 96, 3, generator=torch.Generator().manual_seed(9))
    with torch.no_grad(), entry_numerics(), launches() as n:
        model.features(images.to(dev), torch.tensor([[64.0, 96.0]] * 2, device=dev))
        torch.cuda.synchronize()
    assert n == [want]
