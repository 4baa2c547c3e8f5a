"""Layers that the Swin and ViT backbones share: flax's ``LayerNorm``,
``Dense`` and ``'SAME'`` padding, the JAX initializers, and stochastic depth.

Ports of the flax layers as ``openset_rcnn_tpu/models/swin.py`` and
``openset_rcnn_tpu/models/vit.py`` compose them. Parameters stay f32; a
layer computes in its input's dtype (the trunk's compute dtype), as flax
does with an explicit ``dtype``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# jax.nn.initializers.variance_scaling's "truncated_normal": the std of a
# unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last axis: statistics, scale and
    bias in f32, the result in the input's dtype. The parameters keep flax's
    names (``scale``, ``bias``) so ``utils/jax_params.py`` maps them by name;
    they are parameters, where FrozenBN's ``scale``/``bias`` are buffers."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias, self.eps)
        return y.to(x.dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)


class Linear(nn.Linear):
    """``flax.linen.Dense`` with an explicit dtype: the f32 kernel and bias
    are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype (weights cast to it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """NCHW ``x`` padded as flax's ``padding='SAME'`` pads a conv of square
    ``kernel`` and ``stride``: ceil(n / stride) outputs a side, the smaller
    half of the padding before, the larger after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad's order: last axis first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init, ``lecun_normal``: a normal truncated at two
    standard deviations, with variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def reset_transformer_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX initializers for every Dense, Conv, ConvTranspose and
    LayerNorm under ``module``: lecun_normal kernels with the fan-in of the
    flax kernel's shape ((I, O); (kh, kw, I, O) for both kinds of conv),
    zero biases, LayerNorms at identity. Other parameters (the Swin bias
    tables, the ViT position table) are left to their owners."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
        elif isinstance(m, nn.ConvTranspose2d):  # weight (I, O, kh, kw)
            lecun_normal_(m.weight, m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3], generator)
        elif isinstance(m, nn.Conv2d):  # weight (O, I, kh, kw)
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, LayerNorm):
            m.reset_parameters(generator)
            continue
        else:
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)


def drop_path(y: torch.Tensor, keep_mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Stochastic depth on a residual branch (the JAX blocks' ``_drop_path``):
    the samples where ``keep_mask`` (B,) is true scaled by 1 / keep, the
    others zeroed. A no-op when ``keep_mask`` is None (inference and
    evaluation never pass one) or the block's rate is 0. The divisor is a
    tensor of ``y``'s dtype: JAX divides by the weakly typed keep in ``y``'s
    dtype, and CUDA would multiply by the reciprocal of a Python scalar."""
    if keep_mask is None or rate <= 0.0:
        return y
    keep = torch.full((), 1.0 - rate, dtype=y.dtype, device=y.device)
    mask = keep_mask.to(y.device).reshape(-1, *([1] * (y.ndim - 1)))
    return torch.where(mask, y / keep, torch.zeros((), dtype=y.dtype, device=y.device))
