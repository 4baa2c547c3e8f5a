"""Swin Transformer trunk (Liu et al., arXiv:2103.14030) as its detection
code composes it (Swin-Transformer-Object-Detection, ``mmdet/models/
backbones/swin_transformer.py``), written from the paper and that code in
plain PyTorch; nothing of the program is imported.

A 4x4 patch embedding (a stride-4 convolution, the right and bottom padded
to a multiple of 4) and its LayerNorm; four stages of Swin blocks, tokens
held as (B, H * W, C) sequences; each block is pre-norm windowed
multi-head self-attention with a residual, then a pre-norm MLP (ratio 4,
exact GELU) with a residual. Every block pads the right and bottom of its
H x W grid to multiples of the window, every odd block rolls the padded grid
by half a window (``-shift`` on both axes) and masks, with -100, the logits
between tokens of the nine regions the roll brings together (the mask is
built on the padded grid, each call); the logits are q.k scaled by
head_dim ** -0.5 plus a relative-position bias gathered per head from a
(2w - 1)^2 table. A stage's output is its last block's tokens through that
stage's LayerNorm; between stages, patch merging pads an odd side by one,
concatenates the 2x2 neighbours (x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
x[1::2, 1::2]), normalises and projects 4C to 2C without a bias. Widths C,
2C, 4C, 8C at strides 4, 8, 16, 32.

Departures from the published code, none of which changes an f32 result:

* leaf names are the program's, so one state dict loads into both:
  ``patch_embed``, ``patch_norm``, ``stage{s}_block{b}.norm1``,
  ``.attn.qkv``, ``.attn.proj``, ``.attn.rel_bias_table``, ``.norm2``,
  ``.mlp_fc1``, ``.mlp_fc2``, ``out_norm{s}``, ``downsample{s}.norm`` and
  ``.reduction``; a LayerNorm's weight is ``scale``;
* the relative-position index is a buffer outside the state dict (the
  published code saves it with the weights);
* stochastic depth takes per-sample keep masks (2 * blocks, B) in call
  order from the caller, as the program's training step draws them, or is
  off (inference); dropout and the absolute position embedding are off, as
  the detection config sets them;
* under a bf16 compute dtype the logits, the bias, the mask and the softmax
  are f32 (the program's stated numerics); the detection config runs f32.

Where the program differs from the published code: its patch embedding pads
a side that is no multiple of 4 on both ends (flax's ``'SAME'``), where the
published code pads after; the detector's canvases are multiples of 32, so
the two never meet a side that differs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d
from .transformer import LayerNorm, Linear, drop_path, reset_transformer_parameters

# size -> (embed dim, depths, heads); Swin-B is the detection config's
VARIANTS = {
    "T": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "S": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "B": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
}
PATCH = 4
EPS = 1e-5  # nn.LayerNorm's default


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws, ws, C), windows in row-major order."""
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """(B * nW, ws, ws, C) -> (B, H, W, C)."""
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.view(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, H, W, -1)


def relative_position_index(ws: int) -> torch.Tensor:
    """(ws^2, ws^2) index of each query-key pair's offset into the table."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))  # (2, ws, ws)
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shifted_window_mask(Hp: int, Wp: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    """(nW, ws^2, ws^2) additive mask of the rolled, padded grid: 0 between
    tokens of one region, -100 between regions."""
    img = torch.zeros((1, Hp, Wp, 1), device=device)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    windows = window_partition(img, ws).view(-1, ws * ws)
    mask = windows.unsqueeze(1) - windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.scale = (dim // heads) ** -0.5
        self.rel_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))
        self.register_buffer("rel_index", relative_position_index(ws), persistent=False)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (B * nW, N, C) windows; mask: (nW, N, N) or None."""
        B_, N, C = x.shape
        qkv = self.qkv(x).reshape(B_, N, 3, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q.float() * self.scale) @ k.float().transpose(-2, -1)
        bias = self.rel_bias_table[self.rel_index.view(-1)].view(N, N, -1).permute(2, 0, 1).contiguous()
        attn = attn + bias.float().unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(B_ // nW, nW, self.heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, N, N)
        attn = attn.softmax(dim=-1).to(v.dtype)
        return self.proj((attn @ v).transpose(1, 2).reshape(B_, N, C))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, shift: int, drop_rate: float, mlp_ratio: float = 4.0):
        super().__init__()
        self.ws, self.shift, self.drop_rate = ws, shift, drop_rate
        self.norm1 = LayerNorm(dim, EPS)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = LayerNorm(dim, EPS)
        self.mlp_fc1 = Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, H: int, W: int, mask: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H * W, C); mask: the stage's shifted-window mask."""
        B, L, C = x.shape
        ws, s = self.ws, self.shift
        shortcut = x
        x = self.norm1(x).view(B, H, W, C)
        pad_r, pad_b = (ws - W % ws) % ws, (ws - H % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        _, Hp, Wp, _ = x.shape
        if s > 0:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        windows = self.attn(window_partition(x, ws).view(-1, ws * ws, C), mask if s > 0 else None)
        x = window_reverse(windows.view(-1, ws, ws, C), ws, Hp, Wp)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        x = x[:, :H, :W, :].contiguous().view(B, H * W, C)
        x = shortcut + drop_path(x, None if keep is None else keep[0], self.drop_rate)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + drop_path(y, None if keep is None else keep[1], self.drop_rate)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        x = x.view(B, H, W, C)
        if H % 2 == 1 or W % 2 == 1:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :], x[:, 0::2, 1::2, :], x[:, 1::2, 1::2, :]], -1)
        return self.reduction(self.norm(x.view(B, -1, 4 * C)))


class SwinTransformer(nn.Module):
    """Swin-{T,S,B} -> {res2: C, res3: 2C, res4: 4C, res5: 8C}, NCHW.
    ``embed_dim``, ``depths`` and ``heads`` override the size's (test
    sizes)."""

    def __init__(self, size: str = "B", window: int = 7, compute_dtype: torch.dtype = torch.float32,
                 drop_path_rate: float = 0.0, embed_dim: Optional[int] = None,
                 depths: Optional[Sequence[int]] = None, heads: Optional[Sequence[int]] = None):
        super().__init__()
        C, d, h = VARIANTS[size]
        embed_dim, depths, heads = embed_dim or C, tuple(depths or d), tuple(heads or h)
        self.compute_dtype, self.depths, self.window = compute_dtype, depths, window
        self.patch_embed = Conv2d(3, embed_dim, PATCH, stride=PATCH)
        self.patch_norm = LayerNorm(embed_dim, EPS)
        total = sum(depths)
        rates = [x.item() for x in torch.linspace(0, drop_path_rate, total, device="cpu")]
        self.widths: List[int] = []
        dim, i = embed_dim, 0
        for s, depth in enumerate(depths):
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}",
                                SwinBlock(dim, heads[s], window, 0 if b % 2 == 0 else window // 2, rates[i]))
                i += 1
            self.add_module(f"out_norm{s}", LayerNorm(dim, EPS))
            self.widths.append(dim)
            if s < len(depths) - 1:
                self.add_module(f"downsample{s}", PatchMerging(dim))
                dim *= 2
        self.branch_rates = [r for r in rates for _ in range(2)]  # (attention, MLP) per block

    def forward(self, x: torch.Tensor, drop_path: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: NCHW images; ``drop_path``: (2 * blocks, B) keep masks or None."""
        x = x.to(self.compute_dtype)
        _, _, H, W = x.shape
        if W % PATCH:
            x = F.pad(x, (0, PATCH - W % PATCH))
        if H % PATCH:
            x = F.pad(x, (0, 0, 0, PATCH - H % PATCH))
        x = self.patch_embed(x)
        B, C, H, W = x.shape
        x = self.patch_norm(x.flatten(2).transpose(1, 2))
        outs, i, ws = {}, 0, self.window
        for s, depth in enumerate(self.depths):
            Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
            mask = shifted_window_mask(Hp, Wp, ws, ws // 2, x.device)
            for b in range(depth):
                keep = None if drop_path is None else drop_path[2 * i: 2 * i + 2]
                x = getattr(self, f"stage{s}_block{b}")(x, H, W, mask, keep)
                i += 1
            out = getattr(self, f"out_norm{s}")(x)
            outs[f"res{s + 2}"] = out.view(B, H, W, -1).permute(0, 3, 1, 2).contiguous()
            if s < len(self.depths) - 1:
                x = getattr(self, f"downsample{s}")(x, H, W)
                H, W = (H + 1) // 2, (W + 1) // 2
        return outs

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun-normal kernels, zero biases, LayerNorms at identity, the
        bias tables truncated normal (std 0.02, cut at two)."""
        reset_transformer_parameters(self, generator)
        for m in self.modules():
            if isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.rel_bias_table, std=0.02, a=-0.04, b=0.04, generator=generator)
