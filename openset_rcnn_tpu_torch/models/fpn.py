"""Feature Pyramid Network (P2-P6).

Port of ``openset_rcnn_tpu/models/fpn.py:16-61``: 1x1 lateral convs,
nearest-neighbour x2 top-down pathway, 3x3 output convs, and P6 as the
stride-2 subsample of P5 (d2 ``LastLevelMaxPool``). NCHW. Laterals, the
top-down sums and the output convs run in ``compute_dtype`` (f32 weights cast
inside the convs, ``resnet.Conv2d``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d

IN_FEATURES = ("res2", "res3", "res4", "res5")
IN_CHANNELS = (256, 512, 1024, 2048)  # the ResNet stages'


class FPN(nn.Module):
    """``in_channels``: the widths of res2..res5 (the ResNet's by default;
    JAX infers them from the inputs)."""

    def __init__(self, out_channels: int = 256, compute_dtype: torch.dtype = torch.float32,
                 in_channels: Sequence[int] = IN_CHANNELS):
        super().__init__()
        self.in_features = IN_FEATURES
        self.compute_dtype = compute_dtype
        for f, cin in zip(IN_FEATURES, in_channels):
            self.add_module(f"lateral_{f}", Conv2d(cin, out_channels, 1))
            self.add_module(f"output_{f}", Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        laterals = [getattr(self, f"lateral_{f}")(feats[f].to(self.compute_dtype)) for f in self.in_features]
        tds = [laterals[-1]]  # top-down, coarsest first
        for lat in laterals[-2::-1]:
            up = F.interpolate(tds[-1], scale_factor=2, mode="nearest")
            tds.append(lat + up[:, :, : lat.shape[2], : lat.shape[3]])
        outs = {
            f.replace("res", "p"): getattr(self, f"output_{f}")(td)
            for f, td in zip(self.in_features, tds[::-1])
        }
        outs["p6"] = outs["p5"][:, :, ::2, ::2]
        return outs

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform weights and zero biases, as the JAX module."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
