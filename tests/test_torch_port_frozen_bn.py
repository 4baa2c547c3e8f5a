"""The FrozenBN operator ``openset_rcnn::frozen_bn_act`` (``ops/frozen_bn.py``)
on the CPU: its route there is the ResNet trunk's former composition (the
FrozenBN module, then ``F.relu`` or ``+ sc`` and ``F.relu``) bit for bit, in
bf16 and f32, NCHW and channels_last, in each of its four forms and on NaN,
infinities, signed zeros and subnormals; its registered backward gives
autograd's gradients through that composition bit for bit; ``torch.export``
of a bottleneck block records the operator; a ResNet-50 forward calls it 49
times. The CUDA kernel is held to the same plain version on the card
(``tests/test_torch_port_cuda.py``); the trunk against JAX is
``tests/test_torch_port_models.py``.
"""
import collections

import pytest
import torch
import torch.nn.functional as F

from openset_rcnn_tpu_torch.models import resnet
from openset_rcnn_tpu_torch.ops import frozen_bn
from openset_rcnn_tpu_torch.utils import tracing

FORMS = ("bn", "bn_relu", "bn_identity_relu", "bn_bn_relu")
LAYOUTS = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
INT_VIEW = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def former_affine(x, scale, bias, mean, var, eps):
    """``FrozenBN.forward`` as the trunk ran it before the operator."""
    w = scale / torch.sqrt(var + eps)
    b = bias - mean * w
    w, b = w.to(x.dtype), b.to(x.dtype)
    return x * w[None, :, None, None] + b[None, :, None, None]


def former_bn(x, bn):
    return former_affine(x, bn.scale, bn.bias, bn.mean, bn.var, bn.eps)


def former(form, x, bn, r=None, rbn=None):
    """The trunk's former composition for each form."""
    out = former_bn(x, bn)
    if form == "bn":
        return out
    if form == "bn_identity_relu":
        out = out + r
    elif form == "bn_bn_relu":
        out = out + former_bn(r, rbn)
    return F.relu(out)


def through_operator(form, x, bn, r=None, rbn=None):
    if form == "bn":
        return frozen_bn.frozen_bn_act(x, bn, relu=False)
    if form == "bn_relu":
        return frozen_bn.frozen_bn_act(x, bn)
    if form == "bn_identity_relu":
        return frozen_bn.frozen_bn_act(x, bn, r)
    return frozen_bn.frozen_bn_act(x, bn, r, rbn)


def special(dtype):
    """NaN, both infinities, both zeros, subnormals of ``dtype`` and ordinary values."""
    tiny = torch.finfo(dtype).tiny
    return torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, tiny / 4, -tiny / 64, tiny,
                         -tiny, 1.0, -1.0, 3.5e-3, -250.0], dtype=torch.float32).to(dtype)


def make_bn(C, g, values):
    """A FrozenBN with random statistics; ``special``: channel 0 with scale 0
    (w = 0: inf * 0 is NaN), 1 with var 0 (w = scale / sqrt(eps)), 2 with a
    negative var + eps (NaN w and b), 3 with bias -0.0 and mean 0 (b = -0.0),
    4 with a huge mean, 5 with a scale that makes w subnormal."""
    bn = resnet.FrozenBN(C)
    bn.scale.copy_(torch.rand(C, generator=g) * 2 - 0.5)
    bn.bias.copy_(torch.randn(C, generator=g))
    bn.mean.copy_(torch.randn(C, generator=g) * 3)
    bn.var.copy_(torch.rand(C, generator=g) * 4)
    if values == "special":
        bn.scale[0] = 0.0
        bn.var[1] = 0.0
        bn.var[2] = -1.0
        bn.bias[3], bn.mean[3] = -0.0, 0.0
        bn.mean[4] = 1e30
        bn.scale[5] = 1e-40
    return bn


def activations(shape, dtype, layout, g, values):
    x = torch.randn(shape, generator=g) * 4
    if values == "special":
        flat = x.view(-1)
        idx = torch.randperm(flat.numel(), generator=g)[: flat.numel() // 3]
        vals = special(torch.float32)
        flat[idx] = vals[torch.randint(0, len(vals), (len(idx),), generator=g)]
    return x.to(dtype).contiguous(memory_format=LAYOUTS[layout])


def case(form, dtype, layout, values, seed, shape=(2, 16, 5, 7)):
    g = torch.Generator().manual_seed(seed)
    C = shape[1]
    x = activations(shape, dtype, layout, g, values)
    r = activations(shape, dtype, layout, g, values) if form in ("bn_identity_relu", "bn_bn_relu") else None
    return x, make_bn(C, g, values), r, make_bn(C, g, values) if form == "bn_bn_relu" else None


def assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(INT_VIEW[got.dtype]), want.view(INT_VIEW[want.dtype]))


@pytest.mark.parametrize("values", ["random", "special"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_route_is_the_former_composition(dtype, layout, form, values):
    """Bit for bit (NaN payloads and the sign of zero included), in x's
    memory format, and nothing counted as a kernel launch."""
    x, bn, r, rbn = case(form, DTYPES[dtype], layout, values, seed=len(form) + 3 * (values == "special"))
    tracing.enable()
    try:
        got = through_operator(form, x, bn, r, rbn)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
    assert_bitwise(got, former(form, x, bn, r, rbn))
    assert got.is_contiguous(memory_format=LAYOUTS[layout])
    assert not [k for k in counters if k.startswith("kernel.")]
    if values == "special":  # the values reach the output: NaN, infinities, -0.0 out of the affine
        assert bool(got.isnan().any()) and bool(got.isinf().any() or form != "bn")


@pytest.mark.parametrize("values", ["random", "special"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backward_is_autograd_through_the_former_composition(dtype, form, values):
    """The gradients of x and of the residual, from the operator's
    registered backward, equal autograd's through the former composition,
    bit for bit; ReLU's mask is read from the output as autograd reads it."""
    x, bn, r, rbn = case(form, DTYPES[dtype], "channels_last", values, seed=11 + len(form))
    g = torch.Generator().manual_seed(5)
    grad = torch.randn(x.shape, generator=g).to(x.dtype).contiguous(memory_format=torch.channels_last)
    grads = {}
    for route, fn in (("operator", through_operator), ("former", former)):
        xs = x.clone().requires_grad_(True)
        rs = None if r is None else r.clone().requires_grad_(True)
        fn(form, xs, bn, rs, rbn).backward(grad)
        grads[route] = (xs.grad, None if rs is None else rs.grad)
    for got, want in zip(grads["operator"], grads["former"]):
        if want is None:
            assert got is None
        else:
            assert_bitwise(got, want)


def test_backward_skips_what_needs_no_gradient():
    """Only the residual requires grad: x's gradient is not computed, the
    residual's is autograd's."""
    x, bn, r, rbn = case("bn_bn_relu", torch.float32, "nchw", "random", seed=21)
    grads = []
    for fn in (through_operator, former):
        rs = r.clone().requires_grad_(True)
        fn("bn_bn_relu", x, bn, rs, rbn).sum().backward()
        grads.append(rs.grad)
    assert_bitwise(*grads)


@pytest.mark.parametrize("has_shortcut", [False, True])
def test_export_of_a_bottleneck_block_holds_the_operator(has_shortcut):
    """``torch.export`` of a block records three ``frozen_bn_act`` nodes and
    no ``relu``; the exported program's output is the eager block's, bit for
    bit."""
    cin = 16 if has_shortcut else 32
    block = resnet.BottleneckBlock(cin, 32, 8, 2 if has_shortcut else 1, has_shortcut)
    g = torch.Generator().manual_seed(7)
    for name, buf in block.named_buffers():
        buf.copy_(torch.rand(buf.shape, generator=g) + (0.5 if name.endswith(("scale", "var")) else -0.5))
    for p in block.parameters():
        p.data.copy_(torch.randn(p.shape, generator=g) * 0.2)
    block = block.to(memory_format=torch.channels_last).eval()
    x = torch.randn(2, cin, 12, 10, generator=g).contiguous(memory_format=torch.channels_last)
    program = torch.export.export(block, (x,))
    targets = collections.Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    assert targets["openset_rcnn.frozen_bn_act.default"] == 3
    assert not [t for t in targets if "relu" in t], targets
    with torch.no_grad():
        assert_bitwise(program.module()(x), block(x))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fake_implementation_keeps_shape_dtype_and_memory_format(layout):
    x, bn, r, rbn = case("bn_bn_relu", torch.bfloat16, layout, "random", seed=3)
    meta = lambda t: t.to("meta")
    out = torch.ops.openset_rcnn.frozen_bn_act(
        meta(x), *map(meta, (bn.scale, bn.bias, bn.mean, bn.var)), bn.eps, meta(r),
        *map(meta, (rbn.scale, rbn.bias, rbn.mean, rbn.var)), rbn.eps, True)
    assert (out.shape, out.dtype, out.device.type) == (x.shape, torch.bfloat16, "meta")
    assert out.is_contiguous(memory_format=LAYOUTS[layout])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_r50_trunk_calls_the_operator_once_per_stem_and_three_times_per_block(dtype, monkeypatch):
    """A ResNet-50 forward makes 49 operator calls: the stem's and each
    block's bn1, bn2 with ReLU (33), 4 blocks ending in their shortcut's
    FrozenBN, 12 in the identity; its outputs are those of the former
    blocks, bit for bit."""
    model = resnet.ResNet(50, compute_dtype=DTYPES[dtype])
    g = torch.Generator().manual_seed(9)
    model.reset_parameters(g)
    for bn in (m for m in model.modules() if isinstance(m, resnet.FrozenBN)):
        C = bn.scale.numel()
        bn.scale.copy_(torch.rand(C, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(C, generator=g))
        bn.mean.copy_(torch.randn(C, generator=g))
        bn.var.copy_(torch.rand(C, generator=g) * 3 + 0.5)
    model = model.to(memory_format=torch.channels_last)
    x = torch.randn(1, 3, 64, 96, generator=g).contiguous(memory_format=torch.channels_last)
    forms = collections.Counter()
    op = frozen_bn.frozen_bn_act_op

    def counting(x, scale, bias, mean, var, eps, r, r_scale, *rest):
        forms["bn_relu" if r is None else "bn_identity_relu" if r_scale is None else "bn_bn_relu"] += 1
        return op(x, scale, bias, mean, var, eps, r, r_scale, *rest)

    monkeypatch.setattr(frozen_bn, "frozen_bn_act_op", counting)
    with torch.no_grad():
        got = model(x)
    assert forms == {"bn_relu": 33, "bn_bn_relu": 4, "bn_identity_relu": 12}

    def former_block(self, x):
        out = F.relu(former_bn(self.conv1(x), self.bn1))
        out = F.relu(former_bn(self.conv2(out), self.bn2))
        out = former_bn(self.conv3(out), self.bn3)
        sc = former_bn(self.shortcut(x), self.shortcut_bn) if self.has_shortcut else x
        return F.relu(out + sc)

    monkeypatch.setattr(resnet.BottleneckBlock, "forward", former_block)
    # the stem's call, the only one left: bn_relu
    monkeypatch.setattr(frozen_bn, "frozen_bn_act_op", lambda x, *bn_rest: F.relu(former_affine(x, *bn_rest[:5])))
    with torch.no_grad():
        want = model(x)
    for k in want:
        assert_bitwise(got[k], want[k])
