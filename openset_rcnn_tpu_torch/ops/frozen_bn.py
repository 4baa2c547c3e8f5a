"""FrozenBN's affine with an optional residual and ReLU, as one operator.

A ResNet trunk applies FrozenBN 53 times a forward (R50): after the stem,
after each bottleneck's three convolutions and after each shortcut
convolution. The affine folds four f32 buffers into a per-channel scale and
bias (``fold``) and applies them in the activation's dtype (``frozen_bn``,
the module's ``forward``). The block's last affine is followed by the
residual's add and a ReLU.

* ``frozen_bn_act_plain`` is that composition in PyTorch: ``frozen_bn``,
  then ``+ frozen_bn(r)`` or ``+ r``, then ``F.relu``. The CPU route and the
  kernel's oracle.
* The operator ``openset_rcnn::frozen_bn_act`` (``frozen_bn_act_op``): the
  plain version for CPU tensors, ``csrc/frozen_bn_act.cu`` (one pass over
  the activations, the folding inside the kernel) for CUDA tensors, shapes
  only for tracing, so ``torch.export`` records one node a call. There is no
  fallback: a CUDA tensor the kernel does not take raises. Its backward is
  plain PyTorch, the gradients autograd computes through the plain version,
  bit for bit: ReLU's ``threshold_backward`` on the saved output, then
  ``g * w`` for each branch in the activation's dtype (the identity
  residual's gradient is ``g``). FrozenBN trains nothing.
* ``frozen_bn_act`` is what ``models/resnet.py`` calls, with FrozenBN
  modules in place of their buffers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _native
from ..utils import tracing


def fold(scale, bias, mean, var, eps: float, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """FrozenBN's per-channel (w, b): w = scale / sqrt(var + eps), b = bias -
    mean * w, in f32, then in ``dtype``."""
    w = scale / torch.sqrt(var + eps)
    b = bias - mean * w
    # in x's dtype, as JAX's FrozenBN: f32 buffers would promote a bf16
    # trunk back to f32
    return w.to(dtype), b.to(dtype)


def frozen_bn(x, scale, bias, mean, var, eps: float) -> torch.Tensor:
    """x * w + b over NCHW ``x``, per channel, in x's dtype."""
    w, b = fold(scale, bias, mean, var, eps, x.dtype)
    return x * w[None, :, None, None] + b[None, :, None, None]


def frozen_bn_act_plain(x, scale, bias, mean, var, eps, r, r_scale, r_bias, r_mean, r_var, r_eps, relu):
    """act(frozen_bn(x) [+ frozen_bn(r), where r's buffers are given, else + r]),
    act ReLU or none; the operator's signature."""
    out = frozen_bn(x, scale, bias, mean, var, eps)
    if r is not None:
        out = out + (r if r_scale is None else frozen_bn(r, r_scale, r_bias, r_mean, r_var, r_eps))
    return F.relu(out) if relu else out


OPS = torch.library.Library("openset_rcnn", "FRAGMENT")  # ops/nms.py and ops/roi_align.py define the others
OPS.define("frozen_bn_act(Tensor x, Tensor scale, Tensor bias, Tensor mean, Tensor var, float eps, Tensor? r, "
           "Tensor? r_scale, Tensor? r_bias, Tensor? r_mean, Tensor? r_var, float r_eps, bool relu) -> Tensor")

RESIDUAL_NONE, RESIDUAL_IDENTITY, RESIDUAL_FROZEN_BN = 0, 1, 2  # the kernel's forms of r


def _check_buffers(buffers, x, what):
    C = x.shape[1]
    for t in buffers:
        if t.dtype != torch.float32 or tuple(t.shape) != (C,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{what}: each buffer must be ({C},) float32, contiguous, on {x.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _frozen_bn_act_cuda(x, scale, bias, mean, var, eps, r, r_scale, r_bias, r_mean, r_var, r_eps, relu):
    """The CUDA implementation: launches the kernel or raises."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be (N, C, H, W) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    if x.is_contiguous(memory_format=torch.channels_last):
        layout = torch.channels_last
    elif x.is_contiguous():
        layout = torch.contiguous_format
    else:
        raise ValueError(f"x must be channels_last or contiguous NCHW, got strides {x.stride()}")
    _check_buffers((scale, bias, mean, var), x, "frozen_bn_act")
    r_buffers = (r_scale, r_bias, r_mean, r_var)
    given = sum(t is not None for t in r_buffers)
    if given not in (0, 4) or (given and r is None):
        raise ValueError("the residual's FrozenBN takes all four buffers and a residual, or none")
    residual = RESIDUAL_NONE
    if r is not None:
        if r.shape != x.shape or r.dtype != x.dtype or r.device != x.device or not r.is_contiguous(memory_format=layout):
            raise ValueError(f"the residual must have x's shape, dtype, device and memory format, got "
                             f"{tuple(r.shape)} {r.dtype} strides {r.stride()}")
        residual = RESIDUAL_IDENTITY
        if given:
            _check_buffers(r_buffers, x, "frozen_bn_act's residual")
            residual = RESIDUAL_FROZEN_BN
    y = torch.empty_like(x)  # x's strides
    if y.numel() == 0:
        return y
    N, C, H, W = x.shape
    per_load = 16 // x.element_size()
    vectorized = ((C if layout == torch.channels_last else H * W) % per_load == 0
                  and all(t.data_ptr() % 16 == 0 for t in (x, r, y) if t is not None))
    lib = _native.load("frozen_bn_act")
    r_ptrs = [t.data_ptr() if t is not None else None for t in r_buffers]
    with torch.cuda.device(x.device):
        code = lib.frozen_bn_act(
            x.data_ptr(), None if r is None else r.data_ptr(), y.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), mean.data_ptr(), var.data_ptr(), float(eps),
            *r_ptrs, float(r_eps), N, C, H * W, int(x.dtype == torch.bfloat16), int(layout == torch.channels_last),
            residual, int(relu), int(vectorized), torch.cuda.current_stream().cuda_stream,
        )
    _native.check(lib, "frozen_bn_act", code)
    tracing.count("kernel.frozen_bn")
    return y


def _frozen_bn_act_fake(x, scale, bias, mean, var, eps, r, r_scale, r_bias, r_mean, r_var, r_eps, relu):
    """Shape, dtype and strides only, for tracing (``torch.export``): no
    data, no launch, no count."""
    return torch.empty_like(x)


def _setup_context(ctx, inputs, output):
    x, scale, bias, mean, var, eps, r, r_scale, r_bias, r_mean, r_var, r_eps, relu = inputs
    ctx.eps, ctx.r_eps, ctx.relu = eps, r_eps, relu
    ctx.save_for_backward(scale, bias, mean, var, r_scale, r_bias, r_mean, r_var, output if relu else None)


def _backward(ctx, grad):
    """What autograd computes through ``frozen_bn_act_plain``, op for op."""
    scale, bias, mean, var, r_scale, r_bias, r_mean, r_var, out = ctx.saved_tensors
    g = torch.ops.aten.threshold_backward(grad, out, 0) if ctx.relu else grad
    grad_x = grad_r = None
    if ctx.needs_input_grad[0]:
        w, _ = fold(scale, bias, mean, var, ctx.eps, g.dtype)
        grad_x = g * w[None, :, None, None]
    if ctx.needs_input_grad[6]:
        grad_r = g
        if r_scale is not None:
            w, _ = fold(r_scale, r_bias, r_mean, r_var, ctx.r_eps, g.dtype)
            grad_r = g * w[None, :, None, None]
    return grad_x, None, None, None, None, None, grad_r, None, None, None, None, None, None


OPS.impl("frozen_bn_act", frozen_bn_act_plain, "CPU")
OPS.impl("frozen_bn_act", _frozen_bn_act_cuda, "CUDA")
torch.library.register_fake("openset_rcnn::frozen_bn_act", _frozen_bn_act_fake, lib=OPS)
torch.library.register_autograd("openset_rcnn::frozen_bn_act", _backward, setup_context=_setup_context, lib=OPS)
frozen_bn_act_op = torch.ops.openset_rcnn.frozen_bn_act.default


def frozen_bn_act(x: torch.Tensor, bn, residual: Optional[torch.Tensor] = None, residual_bn=None,
                  relu: bool = True) -> torch.Tensor:
    """act(bn(x) [+ residual_bn(residual), or + residual without residual_bn])
    through ``openset_rcnn::frozen_bn_act``; ``bn`` and ``residual_bn`` are
    FrozenBN modules (their ``scale``, ``bias``, ``mean``, ``var`` and
    ``eps``). CUDA tensors launch the kernel, counted by the tracer as
    ``kernel.frozen_bn`` once a call; CPU tensors take the plain version."""
    rb = residual_bn
    r_args = (None,) * 4 + (0.0,) if rb is None else (rb.scale, rb.bias, rb.mean, rb.var, float(rb.eps))
    return frozen_bn_act_op(x, bn.scale, bn.bias, bn.mean, bn.var, float(bn.eps), residual, *r_args, relu)
