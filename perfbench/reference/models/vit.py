"""ViT-B backbone with a simple feature pyramid (ViTDet, Li et al. 2022).

Port of ``openset_rcnn_tpu/models/vit.py:34-239``: a 16x16 patch embed, a
learnable position table kept at its native 14x14 grid and resized to the
runtime patch grid inside the forward (the same bicubic matrices, applied as
``W_h @ table @ W_w.T`` in f32), 12 blocks of windowed attention (14x14)
with global attention in every third, and the simple pyramid: two stride-2
deconvolutions up to P2/P3, P4 as is, a 2x2 max-pool down to P5, each
projected to 256 channels (1x1 conv, LayerNorm, 3x3 conv, LayerNorm), and
P6 = P5[::2, ::2]. Returns {p2..p6} NCHW in ``channels_last`` memory, as the
port's ``FPN`` does, so the heads are unchanged.

Numerics, as the JAX module: q is scaled by the scale cast to q's dtype,
the logits are the q.k product in the compute dtype, then softmax in f32 and
the probabilities cast back; LayerNorm statistics in f32 (eps 1e-6); exact
GELU. Stochastic depth as in ``swin.py``: keep masks (2 * depth, B) in call
order, or off.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d
from .transformer import ConvTranspose2d, LayerNorm, Linear, drop_path, reset_transformer_parameters, same_pad

GLOBAL_EVERY = 3  # every third block attends globally (ViTDet-B: 4 of 12)
EPS = 1e-6


def bicubic_resize_matrix(out_size: int, in_size: int, a: float = -0.75) -> np.ndarray:
    """(out_size, in_size) matrix of torch ``F.interpolate(mode="bicubic",
    align_corners=False)`` along one axis: half-pixel sampling, the cubic
    convolution kernel with A=-0.75, taps clamped at the borders. Copy of
    ``openset_rcnn_tpu/models/vit.py:44-71``."""
    if out_size == in_size:
        return np.eye(out_size, dtype=np.float64)
    scale = in_size / out_size
    x = (np.arange(out_size) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    t = x - x0
    W = np.zeros((out_size, in_size), np.float64)
    rows = np.arange(out_size)
    for k in range(-1, 3):
        d = np.abs(t - k)
        w = np.where(
            d <= 1.0,
            (a + 2.0) * d**3 - (a + 3.0) * d**2 + 1.0,
            np.where(d < 2.0, a * d**3 - 5.0 * a * d**2 + 8.0 * a * d - 4.0 * a, 0.0),
        )
        np.add.at(W, (rows, np.clip(x0 + k, 0, in_size - 1)), w)
    return W


def _window_partition(x: torch.Tensor, w: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B*nh*nw, w, w, C), padding H/W up to multiples of w."""
    B, H, W, C = x.shape
    ph, pw = (w - H % w) % w, (w - W % w) % w
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, C), (Hp, Wp)


def _window_unpartition(x: torch.Tensor, w: int, hw_pad: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    Hp, Wp = hw_pad
    B = x.shape[0] // ((Hp // w) * (Wp // w))
    x = x.reshape(B, Hp // w, Wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, : hw[0], : hw[1]]


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = 1.0 / np.sqrt(dim // num_heads)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (N, L, C)
        N, L, C = x.shape
        qkv = self.qkv(x).reshape(N, L, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)  # (3, N, h, L, d)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * torch.full((), self.scale, dtype=q.dtype, device=q.device)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        return self.proj(torch.matmul(attn, v).permute(0, 2, 1, 3).reshape(N, L, C))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, drop_path: float, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.drop_path = window_size, drop_path  # window 0: global attention
        self.norm1 = LayerNorm(dim, EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, EPS)
        self.mlp_fc1 = Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H, W, C); keep: (2, B) keep masks of the two branches."""
        B, H, W, C = x.shape
        y = self.norm1(x)
        if self.window_size > 0:
            w = self.window_size
            y, hw_pad = _window_partition(y, w)
            y = self.attn(y.reshape(-1, w * w, C))
            y = _window_unpartition(y.reshape(-1, w, w, C), w, hw_pad, (H, W))
        else:
            y = self.attn(y.reshape(B, H * W, C)).reshape(B, H, W, C)
        x = x + drop_path(y, None if keep is None else keep[0], self.drop_path)
        z = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + drop_path(z, None if keep is None else keep[1], self.drop_path)


def _channel_norm(ln: LayerNorm, y: torch.Tensor) -> torch.Tensor:
    """A LayerNorm over the channels of NCHW ``y``."""
    return ln(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ViTSimpleFPN(nn.Module):
    """ViT-B trunk + simple feature pyramid -> {p2..p6} at ``out_channels``.

    ``embed_dim``, ``depth``, ``num_heads``, ``window_size`` and ``pos_grid``
    override ViT-B's (test sizes)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 window_size: int = 14, out_channels: int = 256, pos_grid: Tuple[int, int] = (14, 14),
                 compute_dtype: torch.dtype = torch.float32, drop_path_rate: float = 0.0):
        super().__init__()
        self.patch_size, self.pos_grid, self.depth = patch_size, tuple(pos_grid), depth
        self.compute_dtype = compute_dtype
        self.patch_embed = Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(*pos_grid, embed_dim))
        rates = np.linspace(0.0, drop_path_rate, depth)
        for i in range(depth):
            window = 0 if (i + 1) % GLOBAL_EVERY == 0 else window_size
            self.add_module(f"block{i}", Block(embed_dim, num_heads, window, float(rates[i])))
        self.branch_rates = [float(r) for r in rates for _ in range(2)]  # (attention, MLP) per block
        self.norm = LayerNorm(embed_dim, EPS)
        self.up2a = ConvTranspose2d(embed_dim, embed_dim // 2, 2, stride=2)
        self.up2b = ConvTranspose2d(embed_dim // 2, embed_dim // 4, 2, stride=2)
        for level, cin in (("p2", embed_dim // 4), ("p3", embed_dim // 2), ("p4", embed_dim), ("p5", embed_dim)):
            self.add_module(f"{level}_conv1", Conv2d(cin, out_channels, 1, bias=False))
            self.add_module(f"{level}_ln1", LayerNorm(out_channels, EPS))
            self.add_module(f"{level}_conv2", Conv2d(out_channels, out_channels, 3, padding=1, bias=False))
            self.add_module(f"{level}_ln2", LayerNorm(out_channels, EPS))
        self._resize: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _resize_matrices(self, H: int, W: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (H, W, device)
        if key not in self._resize:
            self._resize[key] = tuple(torch.from_numpy(bicubic_resize_matrix(n, m)).float().to(device)
                                      for n, m in ((H, self.pos_grid[0]), (W, self.pos_grid[1])))
        return self._resize[key]

    def _project(self, y: torch.Tensor, level: str) -> torch.Tensor:
        """1x1 conv, LayerNorm, 3x3 conv, LayerNorm (``p{k}_conv1`` ... ``p{k}_ln2``)."""
        y = _channel_norm(getattr(self, f"{level}_ln1"), getattr(self, f"{level}_conv1")(y))
        return _channel_norm(getattr(self, f"{level}_ln2"), getattr(self, f"{level}_conv2")(y))

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images -> (B, H, W, C) patch tokens with their positions."""
        x = x.to(self.compute_dtype)
        p = self.patch_size
        x = self.patch_embed(same_pad(x, p, p)).permute(0, 2, 3, 1)
        H, W = x.shape[1:3]
        pos = self.pos_embed
        if (H, W) != self.pos_grid:  # the native table stretched to the runtime grid, in f32
            wh, ww = self._resize_matrices(H, W, x.device)
            pos = torch.einsum("hH,HWc,wW->hwc", wh, pos.float(), ww)
        return x + pos.to(x.dtype)

    def pyramid(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The simple pyramid over the normed stride-16 map, NCHW."""
        up2 = F.gelu(self.up2a(x))
        up4 = self.up2b(up2)
        p5 = self._project(F.max_pool2d(x, 2, 2), "p5")  # stride 32: 2x2 max-pool, VALID
        return {"p2": self._project(up4, "p2"), "p3": self._project(up2, "p3"), "p4": self._project(x, "p4"),
                "p5": p5, "p6": p5[:, :, ::2, ::2]}  # stride 64: exact subsampling, not a pool

    def forward(self, x: torch.Tensor, drop_path: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: NCHW images; ``drop_path``: (2 * depth, B) keep masks or None."""
        x = self.tokens(x)
        for i in range(self.depth):
            keep = None if drop_path is None else drop_path[2 * i: 2 * i + 2]
            x = getattr(self, f"block{i}")(x, keep)
        return self.pyramid(self.norm(x).permute(0, 3, 1, 2))  # NCHW, channels_last memory

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers: lecun_normal kernels (fan-in of the flax
        kernel), zero biases, LayerNorms at identity, the position table
        normal (std 0.02)."""
        reset_transformer_parameters(self, generator)
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)
