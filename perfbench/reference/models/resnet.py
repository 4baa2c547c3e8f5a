"""ResNet backbone with FrozenBN and torch-style symmetric padding.

Port of ``openset_rcnn_tpu/models/resnet.py:26-138``. Module and buffer
names follow the JAX parameter tree (``stem_conv``, ``res2_block0.conv1``,
``bn1.scale`` ...), so ``utils/jax_params.py`` maps one onto the other by
name. Tensors are NCHW; on the GPU they live in ``channels_last`` memory.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# Block counts per stage for each supported depth.
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
STEM_CHANNELS = 64
RES2_OUT_CHANNELS = 256  # doubles per stage: res5 has 2048


class FrozenBN(nn.Module):
    """BatchNorm with frozen statistics and affine parameters (buffers)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.scale / torch.sqrt(self.var + self.eps)
        b = self.bias - self.mean * w
        # in x's dtype, as JAX's FrozenBN: f32 buffers would promote a bf16
        # trunk back to f32
        w, b = w.to(x.dtype), b.to(x.dtype)
        return x * w[None, :, None, None] + b[None, :, None, None]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: the f32 weight and bias are cast to
    it (a no-op for f32 inputs), so a bf16 activation runs a bf16 conv."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=False)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck; the stride sits in the first 1x1 conv
    (d2 ``STRIDE_IN_1X1``, the setting of every config here)."""

    def __init__(self, cin: int, out_channels: int, bottleneck_channels: int, stride: int, has_shortcut: bool):
        super().__init__()
        self.conv1 = _conv(cin, bottleneck_channels, 1, stride)
        self.bn1 = FrozenBN(bottleneck_channels)
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3)
        self.bn2 = FrozenBN(bottleneck_channels)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1)
        self.bn3 = FrozenBN(out_channels)
        self.has_shortcut = has_shortcut
        if has_shortcut:
            self.shortcut = _conv(cin, out_channels, 1, stride)
            self.shortcut_bn = FrozenBN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = self.shortcut_bn(self.shortcut(x)) if self.has_shortcut else x
        return F.relu(out + sc)


class ResNet(nn.Module):
    """Returns {res2, res3, res4, res5} NCHW feature maps in ``compute_dtype``.

    ``remat`` (``TPU.REMAT``, JAX's ``nn.remat(BottleneckBlock)`` at
    ``openset_rcnn_tpu/models/resnet.py:104, 116``): while gradients are
    enabled, each bottleneck block keeps only its input and recomputes its
    activations in the backward pass (``torch.utils.checkpoint``). The
    gradients are those without it, bit for bit.
    """

    def __init__(self, depth: int = 50, compute_dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.stem_conv = _conv(3, STEM_CHANNELS, 7, 2)
        self.stem_bn = FrozenBN(STEM_CHANNELS)
        self.stages = []  # [(stage name, [block names])]
        cin, out_ch = STEM_CHANNELS, RES2_OUT_CHANNELS
        for stage_idx, num_blocks in enumerate(STAGE_BLOCKS[depth]):
            stage = f"res{stage_idx + 2}"
            names = []
            for b in range(num_blocks):
                stride = 2 if (b == 0 and stage_idx > 0) else 1
                names.append(f"{stage}_block{b}")
                self.add_module(names[-1], BottleneckBlock(cin, out_ch, out_ch // 4, stride, has_shortcut=b == 0))
                cin = out_ch
            self.stages.append((stage, names))
            out_ch *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.compute_dtype)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        outputs = {}
        for stage, names in self.stages:
            for name in names:
                block = getattr(self, name)
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False)
                else:
                    x = block(x)
            outputs[stage] = x
        return outputs

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal (fan_out) conv init, as the JAX module's initializer."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=generator)
