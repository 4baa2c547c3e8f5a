"""EVA-02 (Fang et al., arXiv:2303.11331) in the ViTDet frame, as
baaivision/EVA's ``EVA-02/det`` builds its ViTDet trunks (``ViT``,
``Block``, ``Attention``, ``SwiGLU``, ``VisionRotaryEmbeddingFast``),
written from those equations in plain PyTorch; nothing of the program is
imported.

A 16x16 stride-16 patch embedding (a bias), tokens held as (B, H, W, C); an
absolute position table on its pre-training grid, resized to the patch grid
by ``F.interpolate`` (bicubic, align_corners False) and added. Blocks, each
``x + attn(norm1(x))`` then ``x + mlp(norm2(x))``, attend in windows of
``window`` (bottom and right zero-padded, no mask) or, in
``global_blocks``, over the whole grid. The attention: q = x Wq + q_bias,
k = x Wk (no bias), v = x Wv + v_bias; per head (width d) RoPE on q and k;
``softmax((q * d ** -0.5) @ k^T)`` in f32; ``@ v``; heads merged; a Linear.
RoPE (``VisionRotaryEmbeddingFast`` with ``dim`` = d / 2): frequencies
``1 / 10000 ** (arange(0, d/2, 2) / (d/2))``; positions ``arange(n) / ft *
pt``, each frequency repeated twice in a row, the rows' phases over the
first d/2 of the head and the columns' over the second; ``x cos + rotate_half(x)
sin`` with ``rotate_half`` mapping each pair (x1, x2) to (-x2, x1), in f32.
Windows take ft = ``window`` (the positions inside the window), global
blocks ft = ``rope_global_ft``. The MLP is SwiGLU with sub-LN: ``w3(ffn_ln(
silu(w1 x) * w2 x))``. LayerNorm eps 1e-6 throughout. A final LayerNorm,
then the simple pyramid of ``vit.py`` (its ``pyramid``, imported).

TF32 is off for matrix products and convolutions from import on
(``numerics`` in ``model.py`` sets the flags of each run's precision).

Departures from the published code, none of which changes an f32 result
at the shapes the benchmark runs:

* leaf names are the program's, so one state dict loads into both:
  ``pos_embed`` (H, W, C), ``patch_embed``, ``block{i}.norm1``,
  ``.attn.q_bias``, ``.attn.v_bias``, ``.attn.qkv`` (Wq, Wk, Wv stacked,
  no bias), ``.attn.proj``, ``.norm2``, ``.mlp.w1``, ``.mlp.w2``,
  ``.mlp.ffn_ln``, ``.mlp.w3``, ``norm``, the pyramid's; a LayerNorm's
  weight is ``scale``;
* the global blocks' RoPE is read at the rows and columns of the grid
  present, where the published code pads every image to a 96 x 96 grid
  (1536 LSJ);
* the pyramid is the port's (one first deconvolution shared by P2 and P3,
  GELU without a LayerNorm between) after a final trunk norm;
* q_bias and v_bias are drawn truncated normal (std 0.02) by
  ``reset_parameters``, where the published init is zeros;
* stochastic depth takes per-sample keep masks (2 * depth, B) in call order
  from the caller, or is off.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d
from .transformer import ConvTranspose2d, LayerNorm, Linear, drop_path, reset_transformer_parameters, same_pad
from .vit import ViTSimpleFPN, _window_partition, _window_unpartition

torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

EPS = 1e-6
PATCH = 16
THETA = 10000.0


def rope_freqs(h: int, w: int, pt: int, ft: int, head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (h * w, head_dim), of the tokens of an h x w grid in
    row-major order: ``VisionRotaryEmbeddingFast`` at ``pt`` and ``ft``."""
    dim = head_dim // 2
    freqs = 1.0 / (THETA ** (torch.arange(0, dim, 2)[: dim // 2].float() / dim))

    def axis(n):
        t = torch.arange(n).float() / ft * pt
        return torch.einsum("i,f->if", t, freqs).repeat_interleave(2, dim=-1)  # "... n -> ... (n r)", r = 2

    fh, fw = axis(h), axis(w)
    phase = torch.cat((fh[:, None, :].expand(h, w, dim), fw[None, :, :].expand(h, w, dim)), dim=-1)
    return phase.cos().reshape(h * w, head_dim), phase.sin().reshape(h * w, head_dim)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x * cos + rotate_half(x) * sin


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        N, L, C = x.shape
        wq, wk, wv = self.qkv.weight.to(x.dtype).chunk(3, dim=0)
        q = F.linear(x, wq, self.q_bias.to(x.dtype))
        k = F.linear(x, wk)
        v = F.linear(x, wv, self.v_bias.to(x.dtype))
        q, k, v = (t.reshape(N, L, self.num_heads, self.head_dim).transpose(1, 2) for t in (q, k, v))
        q, k = rope(q, cos, sin).to(v.dtype), rope(k, cos, sin).to(v.dtype)
        attn = torch.softmax((q * self.head_dim ** -0.5) @ k.transpose(-2, -1), dim=-1, dtype=torch.float32)
        out = attn.to(v.dtype) @ v
        return self.proj(out.transpose(1, 2).reshape(N, L, C))


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1 = Linear(dim, hidden)
        self.w2 = Linear(dim, hidden)
        self.ffn_ln = LayerNorm(hidden, EPS)
        self.w3 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hidden = F.silu(self.w1(x)) * self.w2(x)
        return self.w3(self.ffn_ln(hidden))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, hidden: int, drop_path: float):
        super().__init__()
        self.window, self.drop_path = window, drop_path
        self.norm1 = LayerNorm(dim, EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, EPS)
        self.mlp = SwiGLU(dim, hidden)

    def forward(self, x: torch.Tensor, rope_win, rope_glb, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        shortcut = x
        B, H, W, C = x.shape
        x = self.norm1(x)
        if self.window:
            ws = self.window
            x, pad_hw = _window_partition(x, ws)
            x = self.attn(x.reshape(-1, ws * ws, C), *rope_win).reshape(-1, ws, ws, C)
            x = _window_unpartition(x, ws, pad_hw, (H, W))
        else:
            x = self.attn(x.reshape(B, H * W, C), *rope_glb).reshape(B, H, W, C)
        x = shortcut + drop_path(x, None if keep is None else keep[0], self.drop_path)
        return x + drop_path(self.mlp(self.norm2(x)), None if keep is None else keep[1], self.drop_path)


class EVA02(nn.Module):
    """EVA-02 trunk + the simple pyramid -> {p2..p6} at 256 channels."""

    pyramid = ViTSimpleFPN.pyramid
    _project = ViTSimpleFPN._project

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16, mlp_hidden: int = 2730,
                 window: int = 16, global_blocks: Sequence[int] = (2, 5, 8, 11, 14, 17, 20, 23),
                 pos_grid: int = 16, rope_pt: int = 16, rope_global_ft: int = 96, drop_path_rate: float = 0.0,
                 out_channels: int = 256, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth, self.window, self.compute_dtype = depth, window, compute_dtype
        self.head_dim, self.rope_pt, self.rope_global_ft = embed_dim // num_heads, rope_pt, rope_global_ft
        self.patch_embed = Conv2d(3, embed_dim, PATCH, stride=PATCH)
        self.pos_embed = nn.Parameter(torch.zeros(pos_grid, pos_grid, embed_dim))
        rates = [x.item() for x in torch.linspace(0, drop_path_rate, depth, device="cpu")]
        for i in range(depth):
            self.add_module(f"block{i}", Block(embed_dim, num_heads, 0 if i in global_blocks else window,
                                               mlp_hidden, rates[i]))
        self.branch_rates = [r for r in rates for _ in range(2)]
        self.norm = LayerNorm(embed_dim, EPS)
        self.up2a = ConvTranspose2d(embed_dim, embed_dim // 2, 2, stride=2)
        self.up2b = ConvTranspose2d(embed_dim // 2, embed_dim // 4, 2, stride=2)
        for level, cin in (("p2", embed_dim // 4), ("p3", embed_dim // 2), ("p4", embed_dim), ("p5", embed_dim)):
            self.add_module(f"{level}_conv1", Conv2d(cin, out_channels, 1, bias=False))
            self.add_module(f"{level}_ln1", LayerNorm(out_channels, EPS))
            self.add_module(f"{level}_conv2", Conv2d(out_channels, out_channels, 3, padding=1, bias=False))
            self.add_module(f"{level}_ln2", LayerNorm(out_channels, EPS))

    def trunk(self, x: torch.Tensor, drop_path: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NCHW images -> the normed stride-16 map, NCHW."""
        x = self.patch_embed(same_pad(x.to(self.compute_dtype), PATCH, PATCH)).permute(0, 2, 3, 1)
        H, W = x.shape[1:3]
        pos = self.pos_embed.float().permute(2, 0, 1)[None]
        if tuple(pos.shape[2:]) != (H, W):
            pos = F.interpolate(pos, size=(H, W), mode="bicubic", align_corners=False)
        x = x + pos[0].permute(1, 2, 0).to(x.dtype)
        dev = x.device
        rope_win = tuple(t.to(dev) for t in rope_freqs(self.window, self.window, self.rope_pt, self.window,
                                                       self.head_dim))
        rope_glb = tuple(t.to(dev) for t in rope_freqs(H, W, self.rope_pt, self.rope_global_ft, self.head_dim))
        for i in range(self.depth):
            keep = None if drop_path is None else drop_path[2 * i: 2 * i + 2]
            x = getattr(self, f"block{i}")(x, rope_win, rope_glb, keep)
        return self.norm(x).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, drop_path: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: NCHW images; ``drop_path``: (2 * depth, B) keep masks or None."""
        return self.pyramid(self.trunk(x, drop_path))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun_normal kernels, zero biases, LayerNorms at identity, the
        position table normal (std 0.02), q_bias and v_bias truncated normal
        (std 0.02, cut at two)."""
        reset_transformer_parameters(self, generator)
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, Attention):
                for t in (m.q_bias, m.v_bias):
                    nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)
