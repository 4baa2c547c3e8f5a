"""MViTv2 trunk (Li et al., arXiv:2112.01526) as detectron2's
``projects/MViTv2`` builds it for detection (``modeling/backbone/mvit.py``:
``MViT``, ``MultiScaleBlock``, ``MultiScaleAttention``; ``utils.py``:
``get_rel_pos``, ``add_decomposed_rel_pos``, ``window_partition``), written
from those equations in plain PyTorch; nothing of the program is imported.

A 7x7 stride-4 patch embedding (padding 3, a bias), tokens held as (B, H,
W, C), no absolute position. Block i is built with (dim, dim_out, heads,
stride_q, stride_kv, window, input size) from the schedule (``schedule``):
stride_q 2 where block i - 1 ends a stage; stride_kv twice the stage's in
the last blocks of stages 2 and 3; window 0 (global) in the last blocks of
stages 2-4; after a stage end the width and heads double and the stage's
kv stride halves (at least 1); after the block that follows a stage end the
window and the input size halve.

A block: ``xn = norm1(x)``; attention of ``xn``; the shortcut ``x``, or
``proj(xn)`` where the width changes, max-pooled (kernel stride_q + 1,
stride stride_q, padding (stride_q + 1) // 2) where stride_q > 1; the sum;
then ``x + mlp_fc2(GELU(mlp_fc1(norm2(x))))``. The attention: one Linear
gives q, k, v as (B * heads, H, W, d); each is pooled by a depthwise
convolution (kernel 3, padding 1, no bias; q at stride_q, k and v at
stride_kv) and a LayerNorm over d; windows are cut after pooling (q of
window // stride_q, k and v of window // stride_kv, zero-padded on the
bottom and right, no mask); logits ``(q * d ** -0.5) @ k^T`` plus the
decomposed relative positions taken against the unscaled q (each axis's
table resized by linear interpolation to 2 * max(q, k) - 1 rows where it
has another size, indexed by q * max(k / q, 1) - k * max(q / k, 1) + (k - 1)
* max(q / k, 1)); softmax; ``@ v``; windows undone and cropped; ``+ q``
(residual pooling); heads merged; a Linear. Each stage's output is its
last block's tokens through a LayerNorm of its own, as NCHW: widths C, 2C,
4C, 8C at strides 4, 8, 16, 32. LayerNorm eps 1e-6 throughout; exact GELU.

TF32 is off for matrix products and convolutions from import on
(``numerics`` in ``model.py`` sets the flags of each run's precision).

Departures from the published code, none of which changes an f32 result:

* leaf names are the program's, so one state dict loads into both:
  ``patch_embed``, ``block{i}.norm1``, ``.attn.qkv``, ``.attn.pool_{q,k,v}``,
  ``.attn.norm_{q,k,v}``, ``.attn.rel_pos_{h,w}``, ``.attn.proj``,
  ``.proj``, ``.norm2``, ``.mlp_fc1``, ``.mlp_fc2``, ``out_norm{s}``; a
  LayerNorm's weight is ``scale``;
* the relative-position tables are drawn truncated normal (std 0.02) by
  ``reset_parameters``, where the published init is zeros: at zeros the
  term vanishes on random weights and no comparison could see it;
* stochastic depth takes per-sample keep masks (2 * depth, B) in call order
  from the caller, as the program's training step draws them, or is off;
* under a bf16 compute dtype the logits, the relative positions and the
  softmax are f32 (the program's stated numerics); the detection config
  runs f32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d
from .transformer import LayerNorm, Linear, drop_path, reset_transformer_parameters

torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

EPS = 1e-6
PATCH = 4  # the patch embedding's stride

# (dim, dim_out, heads, stride_q, stride_kv, window, input size) of a block
Block = Tuple[int, int, int, int, int, int, int]


def schedule(embed_dim: int, depth: int, num_heads: int, last: Sequence[int], kv_stride: int, window: int,
             pretrain_size: int) -> List[Block]:
    """Every block's construction arguments, in order."""
    blocks, dim_out, size = [], embed_dim, pretrain_size // PATCH
    for i in range(depth):
        kv = kv_stride * 2 if i == last[1] or i == last[2] else kv_stride
        blocks.append((embed_dim, dim_out, num_heads, 2 if i - 1 in last else 1, kv,
                       0 if i in last[1:] else window, size))
        embed_dim = dim_out
        if i in last:
            dim_out *= 2
            num_heads *= 2
            kv_stride = max(kv_stride // 2, 1)
        if i - 1 in last:
            window //= 2
            size //= 2
    return blocks


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, d): the table's rows for every query-key offset."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        resized = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1), size=max_rel_dist,
                                mode="linear")
        resized = resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        resized = rel_pos
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return resized[relative_coords.long()]


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                           q_size: Tuple[int, int], k_size: Tuple[int, int]) -> torch.Tensor:
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h).float()
    Rw = get_rel_pos(q_w, k_w, rel_pos_w).float()
    B, _, dim = q.shape
    r_q = q.float().reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return attn.view(B, q_h * q_w, k_h * k_w)


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nW, ws, ws, C), zero-padded to multiples of ws."""
    B, H, W, C = x.shape
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.view(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    return x[:, :H, :W, :].contiguous()


def attention_pool(x: torch.Tensor, pool: nn.Module, norm: Optional[nn.Module] = None) -> torch.Tensor:
    """(B, H, W, C) -> pooled (B, H', W', C), then ``norm``."""
    x = pool(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return norm(x) if norm is not None else x


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, pool_kernel: int, stride_q: int, stride_kv: int,
                 residual_pooling: bool, window_size: int, input_size: int):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim_out // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = Linear(dim, dim_out * 3)
        pad = pool_kernel // 2
        self.pool_q = Conv2d(head_dim, head_dim, pool_kernel, stride=stride_q, padding=pad, groups=head_dim,
                             bias=False)
        self.norm_q = LayerNorm(head_dim, EPS)
        self.pool_k = Conv2d(head_dim, head_dim, pool_kernel, stride=stride_kv, padding=pad, groups=head_dim,
                             bias=False)
        self.norm_k = LayerNorm(head_dim, EPS)
        self.pool_v = Conv2d(head_dim, head_dim, pool_kernel, stride=stride_kv, padding=pad, groups=head_dim,
                             bias=False)
        self.norm_v = LayerNorm(head_dim, EPS)
        self.proj = Linear(dim_out, dim_out)
        self.window_size = window_size
        if window_size:
            self.q_win_size = window_size // stride_q
            self.kv_win_size = window_size // stride_kv
        self.residual_pooling = residual_pooling
        rel_dim = 2 * max(input_size // stride_q, input_size // stride_kv) - 1
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_dim, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_dim, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H, W, 3, self.num_heads, -1).permute(3, 0, 4, 1, 2, 5)
        q, k, v = qkv.reshape(3, B * self.num_heads, H, W, -1).unbind(0)
        q = attention_pool(q, self.pool_q, self.norm_q)
        k = attention_pool(k, self.pool_k, self.norm_k)
        v = attention_pool(v, self.pool_v, self.norm_v)
        ori_q = q
        if self.window_size:
            q, q_hw_pad = window_partition(q, self.q_win_size)
            k, _ = window_partition(k, self.kv_win_size)
            v, _ = window_partition(v, self.kv_win_size)
            q_hw = (self.q_win_size, self.q_win_size)
            kv_hw = (self.kv_win_size, self.kv_win_size)
        else:
            q_hw, kv_hw = q.shape[1:3], k.shape[1:3]
        q = q.reshape(q.shape[0], q_hw[0] * q_hw[1], -1)
        k = k.reshape(k.shape[0], kv_hw[0] * kv_hw[1], -1)
        v = v.reshape(v.shape[0], kv_hw[0] * kv_hw[1], -1)
        attn = ((q * self.scale) @ k.transpose(-2, -1)).float()
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, q_hw, kv_hw)
        attn = attn.softmax(dim=-1).to(v.dtype)
        x = (attn @ v).view(-1, q_hw[0], q_hw[1], v.shape[-1])
        if self.window_size:
            x = window_unpartition(x, self.q_win_size, q_hw_pad, ori_q.shape[1:3])
        if self.residual_pooling:
            x = x + ori_q
        H, W = x.shape[1], x.shape[2]
        x = x.view(B, self.num_heads, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
        return self.proj(x)


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, mlp_ratio: float, drop_rate: float,
                 pool_kernel: int, stride_q: int, stride_kv: int, residual_pooling: bool, window_size: int,
                 input_size: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, EPS)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, pool_kernel, stride_q, stride_kv,
                                        residual_pooling, window_size, input_size)
        self.drop_rate = drop_rate
        if dim != dim_out:
            self.proj = Linear(dim, dim_out)
        self.norm2 = LayerNorm(dim_out, EPS)
        self.mlp_fc1 = Linear(dim_out, int(dim_out * mlp_ratio))
        self.mlp_fc2 = Linear(int(dim_out * mlp_ratio), dim_out)
        self.pool_skip = nn.MaxPool2d(stride_q + 1, stride_q, (stride_q + 1) // 2) if stride_q > 1 else None

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_norm = self.norm1(x)
        x_block = self.attn(x_norm)
        if hasattr(self, "proj"):
            x = self.proj(x_norm)
        if self.pool_skip is not None:
            x = attention_pool(x, self.pool_skip)
        x = x + drop_path(x_block, None if keep is None else keep[0], self.drop_rate)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + drop_path(y, None if keep is None else keep[1], self.drop_rate)


class MViT(nn.Module):
    """MViTv2 -> {res2: C, res3: 2C, res4: 4C, res5: 8C}, NCHW."""

    def __init__(self, embed_dim: int = 144, depth: int = 48, num_heads: int = 2,
                 last_block_indexes: Sequence[int] = (1, 7, 43, 47), qkv_pool_kernel: int = 3,
                 adaptive_kv_stride: int = 4, adaptive_window_size: int = 56, residual_pooling: bool = True,
                 mlp_ratio: float = 4.0, pretrain_size: int = 224, drop_path_rate: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype, self.last = compute_dtype, tuple(last_block_indexes)
        self.patch_embed = Conv2d(3, embed_dim, 7, stride=PATCH, padding=3)
        dpr = [x.item() for x in torch.linspace(0, drop_path_rate, depth, device="cpu")]
        self.widths: List[int] = []
        for i, (dim, dim_out, heads, sq, skv, win, size) in enumerate(
                schedule(embed_dim, depth, num_heads, self.last, adaptive_kv_stride, adaptive_window_size,
                         pretrain_size)):
            self.add_module(f"block{i}", MultiScaleBlock(dim, dim_out, heads, mlp_ratio, dpr[i], qkv_pool_kernel,
                                                         sq, skv, residual_pooling, win, size))
            if i in self.last:
                self.add_module(f"out_norm{len(self.widths)}", LayerNorm(dim_out, EPS))
                self.widths.append(dim_out)
        self.depth = depth
        self.branch_rates = [r for r in dpr for _ in range(2)]  # (attention, MLP) per block

    def forward(self, x: torch.Tensor, drop_path: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: NCHW images; ``drop_path``: (2 * depth, B) keep masks or None."""
        x = self.patch_embed(x.to(self.compute_dtype)).permute(0, 2, 3, 1)
        outs = {}
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, None if drop_path is None else drop_path[2 * i: 2 * i + 2])
            if i in self.last:
                s = self.last.index(i)
                outs[f"res{s + 2}"] = getattr(self, f"out_norm{s}")(x).permute(0, 3, 1, 2).contiguous()
        return outs

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun-normal kernels, zero biases, LayerNorms at identity, the
        relative-position tables truncated normal (std 0.02, cut at two)."""
        reset_transformer_parameters(self, generator)
        for m in self.modules():
            if isinstance(m, MultiScaleAttention):
                nn.init.trunc_normal_(m.rel_pos_h, std=0.02, a=-0.04, b=0.04, generator=generator)
                nn.init.trunc_normal_(m.rel_pos_w, std=0.02, a=-0.04, b=0.04, generator=generator)
