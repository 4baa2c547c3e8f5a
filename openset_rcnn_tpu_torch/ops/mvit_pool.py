"""MViT's attention pooling of q, k and v, as one operator.

A pooling-attention block (``models/mvit.py``) computes q, k and v of the
whole grid by one Linear, then for each of them, per head: a depthwise
``kernel x kernel`` convolution without a bias (q at ``stride_q``, k and v
at ``stride_kv``, padding ``kernel // 2``), a LayerNorm over the head width
(statistics in f32), and, in a windowed block, the cut into windows
(``models/vit.py::_window_partition``: the grid padded with zeros at the
bottom and right to a multiple of the window).

* ``mvit_pool_norm_plain`` is that composition in PyTorch, op for op as the
  block ran it: the split of the Linear's output into (3, B * heads, H, W,
  d), ``F.conv2d``, ``F.layer_norm`` on the f32 values, ``_window_partition``.
  The CPU route and the kernel's oracle.
* The operator ``openset_rcnn::mvit_pool_norm`` (``mvit_pool_norm_op``): the
  plain version for CPU tensors, ``csrc/mvit_pool_norm.cu`` (one launch for
  q, k and v, reading the Linear's output in place and writing each output
  once, at its window position) for CUDA tensors, shapes only for tracing.
  There is no fallback: a CUDA tensor the kernel does not take raises. Its
  backward is plain PyTorch: the gradients autograd computes through the
  plain version, found by running it again on the saved inputs.
* ``mvit_pool_norm`` is what ``models/mvit.py`` calls, with the block's
  attention module in place of its weights.

Outputs: windowed (``q_window``, ``kv_window`` > 0), (B * heads * windows,
window * window, d) each, in ``_window_partition``'s order, the padded
positions zeros; global (both 0), (B * heads, H' * W', d).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .. import _native
from ..utils import tracing

KERNEL = 3  # the kernel's pooling kernel side
STRIDES = (1, 2, 3, 4)  # the kernel's strides
MAX_HEAD_WIDTH = 256  # the kernel's head widths: multiples of 4 up to this


def pooled_side(n: int, kernel: int, stride: int) -> int:
    """The side of a pooled grid: a kernel-``kernel`` convolution at
    ``stride`` with padding ``kernel // 2``."""
    return (n + 2 * (kernel // 2) - kernel) // stride + 1


def mvit_pool_norm_plain(qkv, w_q, w_k, w_v, s_q, b_q, s_k, b_k, s_v, b_v, heads: int, stride_q: int,
                         stride_kv: int, q_window: int, kv_window: int, eps: float):
    """(q, k, v) from the qkv Linear's output (B, H, W, 3 * heads * d): per
    tensor the depthwise conv (weights (d, 1, k, k)), the LayerNorm (scale
    and bias (d,)) and, where its window is not 0, the window cut; the
    operator's signature."""
    from ..models import vit  # here: the models import ops, which import this module

    B, H, W, _ = qkv.shape
    x = qkv.reshape(B, H, W, 3, heads, -1).permute(3, 0, 4, 1, 2, 5).reshape(3, B * heads, H, W, -1)
    out = []
    for t, w, scale, bias, stride, window in zip(x, (w_q, w_k, w_v), (s_q, s_k, s_v), (b_q, b_k, b_v),
                                                 (stride_q, stride_kv, stride_kv), (q_window, kv_window, kv_window)):
        d, k = w.shape[0], w.shape[-1]
        y = F.conv2d(t.permute(0, 3, 1, 2), w.to(t.dtype), None, stride, k // 2, 1, d).permute(0, 2, 3, 1)
        y = F.layer_norm(y.float(), (d,), scale, bias, eps).to(y.dtype)
        if window:
            y, _ = vit._window_partition(y, window)
        out.append(y.reshape(y.shape[0], -1, d))
    return tuple(out)


def output_shapes(B: int, H: int, W: int, heads: int, d: int, kernel: int, stride_q: int, stride_kv: int,
                  q_window: int, kv_window: int) -> Tuple[Tuple[int, int, int], ...]:
    """The shapes of (q, k, v)."""
    shapes = []
    for stride, window in ((stride_q, q_window), (stride_kv, kv_window), (stride_kv, kv_window)):
        h, w = pooled_side(H, kernel, stride), pooled_side(W, kernel, stride)
        if window:
            shapes.append((B * heads * -(-h // window) * -(-w // window), window * window, d))
        else:
            shapes.append((B * heads, h * w, d))
    return tuple(shapes)


OPS = torch.library.Library("openset_rcnn", "FRAGMENT")  # ops/nms.py, ops/roi_align.py, ops/frozen_bn.py the others
OPS.define("mvit_pool_norm(Tensor qkv, Tensor w_q, Tensor w_k, Tensor w_v, Tensor s_q, Tensor b_q, Tensor s_k, "
           "Tensor b_k, Tensor s_v, Tensor b_v, int heads, int stride_q, int stride_kv, int q_window, int kv_window, "
           "float eps) -> (Tensor, Tensor, Tensor)")


def _check_cuda(qkv, weights, norms, heads, stride_q, stride_kv, q_window, kv_window):
    """Raise ``ValueError`` on what the kernel does not take; return d."""
    if qkv.dtype != torch.float32 or qkv.dim() != 4:
        raise ValueError(f"qkv must be (B, H, W, 3 * heads * d) float32, got {tuple(qkv.shape)} {qkv.dtype}")
    d = weights[0].shape[0]
    if d % 4 or not 4 <= d <= MAX_HEAD_WIDTH:
        raise ValueError(f"the kernel takes head widths that are multiples of 4 up to {MAX_HEAD_WIDTH}, not {d}")
    if qkv.shape[3] != 3 * heads * d:
        raise ValueError(f"qkv has {qkv.shape[3]} channels, not 3 x {heads} heads x {d}")
    for w in weights:
        if tuple(w.shape) != (d, 1, KERNEL, KERNEL) or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError(f"each pooling weight must be ({d}, 1, {KERNEL}, {KERNEL}) float32, contiguous; got "
                             f"{tuple(w.shape)} {w.dtype}")
    for t in norms:
        if tuple(t.shape) != (d,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"each norm's scale and bias must be ({d},) float32, contiguous; got {tuple(t.shape)} "
                             f"{t.dtype}")
    if stride_q not in STRIDES or stride_kv not in STRIDES:
        raise ValueError(f"the kernel takes strides {STRIDES}, not {stride_q} and {stride_kv}")
    if q_window < 0 or kv_window < 0 or (q_window == 0) != (kv_window == 0):
        raise ValueError(f"windows {q_window} and {kv_window}: both 0 (global) or both positive")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"qkv must be contiguous and 16-byte aligned, got strides {qkv.stride()}")
    if any(t.device != qkv.device for t in (*weights, *norms)) or qkv.device.type != "cuda":
        raise ValueError(f"every tensor must be on one CUDA device, qkv is on {qkv.device}")
    return d


def _mvit_pool_norm_cuda(qkv, w_q, w_k, w_v, s_q, b_q, s_k, b_k, s_v, b_v, heads, stride_q, stride_kv, q_window,
                         kv_window, eps):
    """The CUDA implementation: launches the kernel or raises."""
    weights, norms = (w_q, w_k, w_v), (s_q, b_q, s_k, b_k, s_v, b_v)
    d = _check_cuda(qkv, weights, norms, heads, stride_q, stride_kv, q_window, kv_window)
    B, H, W, _ = qkv.shape
    if B > 65535:
        raise ValueError(f"the kernel takes at most 65535 images, not {B}")
    outs = [torch.empty(s, dtype=qkv.dtype, device=qkv.device)
            for s in output_shapes(B, H, W, heads, d, KERNEL, stride_q, stride_kv, q_window, kv_window)]
    if qkv.numel() == 0:
        return tuple(outs)
    lib = _native.load("mvit_pool_norm")
    with torch.cuda.device(qkv.device):
        code = lib.mvit_pool_norm(
            qkv.data_ptr(), *(t.data_ptr() for t in outs), *(t.data_ptr() for t in (*weights, *norms)), float(eps),
            B, H, W, heads, d, stride_q, stride_kv, q_window, kv_window, torch.cuda.current_stream().cuda_stream)
    _native.check(lib, "mvit_pool_norm", code)
    tracing.count("kernel.mvit_pool_norm")
    return tuple(outs)


def _mvit_pool_norm_fake(qkv, w_q, w_k, w_v, s_q, b_q, s_k, b_k, s_v, b_v, heads, stride_q, stride_kv, q_window,
                         kv_window, eps):
    """Shapes and dtype only, for tracing (``torch.export``): no data, no
    launch, no count."""
    B, H, W, _ = qkv.shape
    return tuple(qkv.new_empty(s) for s in output_shapes(B, H, W, heads, w_q.shape[0], w_q.shape[-1], stride_q,
                                                         stride_kv, q_window, kv_window))


def _setup_context(ctx, inputs, output):
    ctx.args = inputs[10:]
    ctx.save_for_backward(*inputs[:10])


def _backward(ctx, *grads):
    """What autograd computes through ``mvit_pool_norm_plain``: the plain
    version run again on the saved inputs, then ``torch.autograd.grad``."""
    needs = ctx.needs_input_grad[:10]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        outs = mvit_pool_norm_plain(*inputs, *ctx.args)
    used = [(o, g) for o, g in zip(outs, grads) if g is not None]
    wanted = [t for t, n in zip(inputs, needs) if n]
    found = iter(torch.autograd.grad([o for o, _ in used], wanted, [g for _, g in used], allow_unused=True)
                 if wanted and used else [None] * len(wanted))
    return (*(next(found) if n else None for n in needs), None, None, None, None, None, None)


OPS.impl("mvit_pool_norm", mvit_pool_norm_plain, "CPU")
OPS.impl("mvit_pool_norm", _mvit_pool_norm_cuda, "CUDA")
torch.library.register_fake("openset_rcnn::mvit_pool_norm", _mvit_pool_norm_fake, lib=OPS)
torch.library.register_autograd("openset_rcnn::mvit_pool_norm", _backward, setup_context=_setup_context, lib=OPS)
mvit_pool_norm_op = torch.ops.openset_rcnn.mvit_pool_norm.default


def mvit_pool_norm(qkv: torch.Tensor, attn) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v) of ``attn``, a ``models/mvit.py::MultiScaleAttention`` (its
    ``num_heads``, ``pool_q``/``_k``/``_v`` convolutions, ``norm_q``/``_k``/``_v``
    LayerNorms, strides and windows), from its qkv Linear's output, through
    ``openset_rcnn::mvit_pool_norm``. CUDA tensors launch the kernel,
    counted by the tracer as ``kernel.mvit_pool_norm`` once a call; CPU
    tensors take the plain version."""
    a = attn
    return mvit_pool_norm_op(qkv, a.pool_q.weight, a.pool_k.weight, a.pool_v.weight, a.norm_q.scale, a.norm_q.bias,
                             a.norm_k.scale, a.norm_k.bias, a.norm_v.scale, a.norm_v.bias, a.num_heads, a.stride_q,
                             a.stride_kv, a.q_window, a.kv_window, float(a.norm_q.eps))
