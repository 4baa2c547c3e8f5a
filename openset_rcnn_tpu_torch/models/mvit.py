"""MViTv2 backbone (Li et al., arXiv:2112.01526) emitting {res2..res5} for the FPN.

As detectron2's ``projects/MViTv2`` composes it for detection (``MViT``,
``MultiScaleBlock``, ``MultiScaleAttention``): a 7x7 stride-4 patch
embedding (padding 3, with a bias) and no absolute position; blocks of
pooling attention in four stages of widths C, 2C, 4C, 8C at strides 4, 8,
16, 32, each stage's output through a LayerNorm of its own.

A block: ``xn = norm1(x)``; the attention of ``xn``; a shortcut that is
``x``, or ``Linear(xn)`` where the block widens, max-pooled (3x3, stride 2,
padding 1) where the block pools its queries; then the MLP (ratio 4, exact
GELU) with its residual. The attention computes q, k and v of the whole
grid by one Linear, pools each per head with a depthwise 3x3 convolution
(q at ``stride_q``, k and v at ``stride_kv``) and a LayerNorm over the head
width (these and the window cut below are the operator of
``ops/mvit_pool.py``, one CUDA kernel on the card), then attends in windows
cut *after* pooling (q in windows of
``window // stride_q``, k and v of ``window // stride_kv``, the bottom and
right padded with zeros, unmasked; both give the same number of windows) or
globally (``window`` 0), with decomposed relative positions
(``get_rel_pos``: per-axis tables, resized by linear interpolation to the
query and key extents, indexed with scaled coordinates, taken against the
unscaled q), and adds the pooled q back to the output (residual pooling,
in windows where the block attends in windows) before the heads are merged
and projected.

The schedule (``block_schedule``): block i pools its queries 2x when block
i - 1 ends a stage; blocks ``LAST_BLOCK_INDEXES[1:]`` attend globally, and
the last blocks of stages 2 and 3 pool k and v twice as much as their
stage; a stage end doubles the width and the heads and halves the key and
value stride (to at least 1); the block after a stage end halves the window
and the relative-position size that later blocks are built with.

Numerics: LayerNorm statistics in f32; q.k in the compute dtype, the
relative positions added in f32, softmax in f32, the probabilities cast to
v's dtype. Stochastic depth as ``swin.py``: keep masks (2 * depth, B) in
call order, or off. Tokens run as (B, H, W, C); the outputs are NCHW in
``channels_last`` memory. Module names follow the port's other trunks
(``patch_embed``, ``block{i}.attn.qkv``, ``.attn.pool_q``, ``.attn.norm_q``,
``.attn.rel_pos_h``, ``.proj``, ``.mlp_fc1``, ``out_norm{s}``).

Stages: ``resolution_stages()`` gives the four stages (res2..res5, each
ending after its output norm) as calls of their own, so the serving path
marks and captures each; ``forward`` runs the same calls in turn.
Counters (``utils/tracing.py``, once per stage call that runs the Python
code, summed over the stage's blocks and the batch): ``mvit.q_tokens``, the
query tokens after pooling; ``mvit.kv_tokens``, the key/value tokens after
pooling; ``mvit.attn_logits``, the logits materialised, padded windows
included.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mvit_pool import mvit_pool_norm, pooled_side
from ..utils import tracing
from .resnet import Conv2d
from .transformer import LayerNorm, Linear, drop_path, reset_transformer_parameters
from .vit import _window_unpartition

EPS = 1e-6
PATCH_KERNEL, PATCH_STRIDE = 7, 4


class MViTConfig(NamedTuple):
    """``MODEL.MVIT``; the defaults are MViTv2-T's."""

    embed_dim: int = 96
    depth: int = 10
    num_heads: int = 1
    last_block_indexes: Tuple[int, ...] = (0, 2, 7, 9)
    qkv_pool_kernel: int = 3
    adaptive_kv_stride: int = 4
    adaptive_window_size: int = 56
    residual_pooling: bool = True
    mlp_ratio: float = 4.0
    pretrain_size: int = 224
    drop_path_rate: float = 0.0

    @staticmethod
    def from_cfg(node) -> "MViTConfig":
        return MViTConfig(
            embed_dim=node.EMBED_DIM, depth=node.DEPTH, num_heads=node.NUM_HEADS,
            last_block_indexes=tuple(node.LAST_BLOCK_INDEXES), qkv_pool_kernel=node.QKV_POOL_KERNEL,
            adaptive_kv_stride=node.ADAPTIVE_KV_STRIDE, adaptive_window_size=node.ADAPTIVE_WINDOW_SIZE,
            residual_pooling=bool(node.RESIDUAL_POOLING), mlp_ratio=float(node.MLP_RATIO),
            pretrain_size=node.PRETRAIN_SIZE, drop_path_rate=float(node.DROP_PATH_RATE))


class BlockSpec(NamedTuple):
    dim: int
    dim_out: int
    num_heads: int
    stride_q: int
    stride_kv: int
    window: int  # 0: global attention
    rel_size: int  # the grid side the relative-position tables are sized for


def block_schedule(c: MViTConfig) -> List[BlockSpec]:
    """Every block's shape, in order (detectron2's ``MViT.__init__``)."""
    last = c.last_block_indexes
    dim = dim_out = c.embed_dim
    heads, stride_kv, window, size = c.num_heads, c.adaptive_kv_stride, c.adaptive_window_size, c.pretrain_size // 4
    out = []
    for i in range(c.depth):
        out.append(BlockSpec(dim, dim_out, heads, 2 if i - 1 in last else 1,
                             2 * stride_kv if i in (last[1], last[2]) else stride_kv,
                             0 if i in last[1:] else window, size))
        dim = dim_out
        if i in last:
            dim_out, heads, stride_kv = 2 * dim_out, 2 * heads, max(stride_kv // 2, 1)
        if i - 1 in last:
            window, size = window // 2, size // 2
    return out


def rel_pos_index(q_size: int, k_size: int) -> torch.Tensor:
    """(q_size, k_size) rows of a (2 * max(q_size, k_size) - 1)-row table,
    as detectron2 computes them (f32 coordinates, truncated)."""
    q = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    return ((q - k) + (k_size - 1) * max(q_size / k_size, 1.0)).long()


def get_rel_pos(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(q, k, d) relative positions from a (rows, d) table: resized by linear
    interpolation to 2 * max(q, k) - 1 rows where it has another number,
    then gathered at ``index`` (``rel_pos_index``)."""
    rows = 2 * max(index.shape) - 1
    if table.shape[0] != rows:
        table = F.interpolate(table.t()[None], size=rows, mode="linear")[0].t()
    return table[index]


class MultiScaleAttention(nn.Module):
    def __init__(self, spec: BlockSpec, kernel: int, residual_pooling: bool):
        super().__init__()
        dim, dim_out, heads = spec.dim, spec.dim_out, spec.num_heads
        d = dim_out // heads
        self.num_heads, self.scale, self.residual_pooling = heads, d ** -0.5, residual_pooling
        self.kernel, self.stride_q, self.stride_kv = kernel, spec.stride_q, spec.stride_kv
        # 0 and 0: global attention
        self.q_window, self.kv_window = (spec.window // spec.stride_q, spec.window // spec.stride_kv) if spec.window \
            else (0, 0)
        self.qkv = Linear(dim, 3 * dim_out)
        for name, stride in (("q", spec.stride_q), ("k", spec.stride_kv), ("v", spec.stride_kv)):
            self.add_module(f"pool_{name}", Conv2d(d, d, kernel, stride=stride, padding=kernel // 2, groups=d,
                                                   bias=False))
            self.add_module(f"norm_{name}", LayerNorm(d, EPS))
        rows = 2 * max(spec.rel_size // spec.stride_q, spec.rel_size // spec.stride_kv) - 1
        self.rel_pos_h = nn.Parameter(torch.zeros(rows, d))
        self.rel_pos_w = nn.Parameter(torch.zeros(rows, d))
        self.proj = Linear(dim_out, dim_out)
        self._index: Dict[tuple, torch.Tensor] = {}

    def rel_index(self, q_size: int, k_size: int, device: torch.device) -> torch.Tensor:
        """``rel_pos_index`` on ``device``, made once per extent pair (on the
        first, eager call, so a CUDA graph reads it in place)."""
        key = (q_size, k_size, device)
        if key not in self._index:
            self._index[key] = rel_pos_index(q_size, k_size).to(device)
        return self._index[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, dim), normed -> (B, H', W', dim_out) on the pooled
        query grid."""
        B, H, W, _ = x.shape
        h = self.num_heads
        # pooled, normed and (windowed blocks) cut into windows: (N, tokens, d) each
        q, k, v = mvit_pool_norm(self.qkv(x), self)
        qh, qw = pooled_side(H, self.kernel, self.stride_q), pooled_side(W, self.kernel, self.stride_q)
        d = q.shape[-1]
        if self.q_window:
            if q.shape[0] != k.shape[0]:
                raise ValueError(f"{q.shape[0]} query windows against {k.shape[0]} key windows")
            q_hw, kv_hw = (self.q_window,) * 2, (self.kv_window,) * 2
        else:
            q_hw = (qh, qw)
            kv_hw = (pooled_side(H, self.kernel, self.stride_kv), pooled_side(W, self.kernel, self.stride_kv))
        N = q.shape[0]
        attn = torch.matmul(q * self.scale, k.transpose(-1, -2)).float()
        rh = get_rel_pos(self.rel_pos_h, self.rel_index(q_hw[0], kv_hw[0], x.device)).float()
        rw = get_rel_pos(self.rel_pos_w, self.rel_index(q_hw[1], kv_hw[1], x.device)).float()
        rq = q.float().reshape(N, *q_hw, d)
        rel_h = torch.einsum("nhwc,hkc->nhwk", rq, rh)
        rel_w = torch.einsum("nhwc,wkc->nhwk", rq, rw)
        attn = attn.view(N, *q_hw, *kv_hw).add_(rel_h[..., None]).add_(rel_w[..., None, :])
        attn = torch.softmax(attn.view(N, q.shape[1], -1), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v)
        if self.residual_pooling:  # in windows: the padded rows are cropped below
            out = out + q
        out = out.reshape(N, *q_hw, d)
        if self.q_window:
            wq = self.q_window
            out = _window_unpartition(out, wq, (-(-qh // wq) * wq, -(-qw // wq) * wq), (qh, qw))
        out = out.reshape(B, h, qh, qw, d).permute(0, 2, 3, 1, 4).reshape(B, qh, qw, h * d)
        return self.proj(out)


class MultiScaleBlock(nn.Module):
    def __init__(self, spec: BlockSpec, kernel: int, residual_pooling: bool, mlp_ratio: float, drop_path: float):
        super().__init__()
        self.spec, self.kernel, self.drop_path = spec, kernel, drop_path
        self.norm1 = LayerNorm(spec.dim, EPS)
        self.attn = MultiScaleAttention(spec, kernel, residual_pooling)
        if spec.dim != spec.dim_out:
            self.proj = Linear(spec.dim, spec.dim_out)
        self.norm2 = LayerNorm(spec.dim_out, EPS)
        hidden = int(spec.dim_out * mlp_ratio)
        self.mlp_fc1 = Linear(spec.dim_out, hidden)
        self.mlp_fc2 = Linear(hidden, spec.dim_out)

    def counts(self, H: int, W: int) -> Tuple[int, int, int, Tuple[int, int]]:
        """(query tokens, key/value tokens, logits, the output grid) of one
        image on an H x W input grid."""
        s = self.spec
        qh, qw = pooled_side(H, self.kernel, s.stride_q), pooled_side(W, self.kernel, s.stride_q)
        kh, kw = pooled_side(H, self.kernel, s.stride_kv), pooled_side(W, self.kernel, s.stride_kv)
        if s.window:
            wq, wk = self.attn.q_window, self.attn.kv_window
            logits = -(-qh // wq) * -(-qw // wq) * wq * wq * wk * wk
        else:
            logits = qh * qw * kh * kw
        return qh * qw, kh * kw, s.num_heads * logits, (qh, qw)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H, W, dim); keep: (2, B) keep masks of the two branches."""
        xn = self.norm1(x)
        a = self.attn(xn)
        if self.spec.dim != self.spec.dim_out:
            x = self.proj(xn)
        if self.spec.stride_q > 1:
            s = self.spec.stride_q
            x = F.max_pool2d(x.permute(0, 3, 1, 2), s + 1, s, (s + 1) // 2).permute(0, 2, 3, 1)
        x = x + drop_path(a, None if keep is None else keep[0], self.drop_path)
        z = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + drop_path(z, None if keep is None else keep[1], self.drop_path)


class MViT(nn.Module):
    """MViTv2 trunk -> {res2: C@s4, res3: 2C@s8, res4: 4C@s16, res5: 8C@s32}."""

    def __init__(self, config: MViTConfig = MViTConfig(), compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        if len(c.last_block_indexes) != 4:
            raise ValueError(f"MODEL.MVIT.LAST_BLOCK_INDEXES names four stage ends, not {c.last_block_indexes}")
        self.config, self.compute_dtype = c, compute_dtype
        self.patch_embed = Conv2d(3, c.embed_dim, PATCH_KERNEL, stride=PATCH_STRIDE, padding=PATCH_KERNEL // 2)
        rates = [float(r) for r in np.linspace(0.0, c.drop_path_rate, c.depth)]
        self.out_channels: List[int] = []
        for i, spec in enumerate(block_schedule(c)):
            self.add_module(f"block{i}", MultiScaleBlock(spec, c.qkv_pool_kernel, c.residual_pooling, c.mlp_ratio,
                                                         rates[i]))
            if i in c.last_block_indexes:
                self.add_module(f"out_norm{len(self.out_channels)}", LayerNorm(spec.dim_out, EPS))
                self.out_channels.append(spec.dim_out)
        self.branch_rates = [r for r in rates for _ in range(2)]  # (attention, MLP) per block

    def stage(self, s: int, x: torch.Tensor, drop_path: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage ``s``: the patch embedding first (``s`` 0, on NCHW images),
        then the stage's blocks (from the block after the previous stage
        end) and its output norm. Returns (the tokens after the blocks,
        ``res{s + 2}`` as NCHW). Counts its query and key/value tokens after
        pooling and the logits it materialises."""
        if s == 0:
            x = self.patch_embed(x.to(self.compute_dtype)).permute(0, 2, 3, 1)  # (B, H, W, C)
        last = self.config.last_block_indexes
        first = last[s - 1] + 1 if s else 0
        B, H, W, _ = x.shape
        totals = [0, 0, 0]
        for i in range(first, last[s] + 1):
            block = getattr(self, f"block{i}")
            *n, (H, W) = block.counts(H, W)
            totals = [t + B * m for t, m in zip(totals, n)]
            keep = None if drop_path is None else drop_path[2 * i: 2 * i + 2]
            x = block(x, keep)
        for name, n in zip(("mvit.q_tokens", "mvit.kv_tokens", "mvit.attn_logits"), totals):
            tracing.count(name, n)
        return x, getattr(self, f"out_norm{s}")(x).permute(0, 3, 1, 2)

    def resolution_stages(self) -> List[Tuple[str, Callable[..., tuple]]]:
        """The stages in order, as (``res2``..``res5``, fn): ``fn(x, feats)``
        runs ``stage`` on ``x`` (the images, then the previous stage's
        tokens) and returns (its tokens, ``feats`` with its output added)."""
        def run(s):
            def fn(x, feats):
                x, out = self.stage(s, x)
                return x, {**feats, f"res{s + 2}": out}
            return fn

        return [(f"res{s + 2}", run(s)) for s in range(len(self.out_channels))]

    def forward(self, x: torch.Tensor, drop_path: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: NCHW images; ``drop_path``: (2 * depth, B) keep masks or None."""
        outs = {}
        for s in range(len(self.out_channels)):
            x, outs[f"res{s + 2}"] = self.stage(s, x, drop_path=drop_path)
        return outs

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The port's initializers: lecun_normal Linear and Conv kernels,
        zero biases, LayerNorms at identity; the relative-position tables
        truncated normal (std 0.02, cut at two), where the published init is
        zeros, so that the relative positions count on random weights."""
        reset_transformer_parameters(self, generator)
        for m in self.modules():
            if isinstance(m, MultiScaleAttention):
                for t in (m.rel_pos_h, m.rel_pos_w):
                    nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)

