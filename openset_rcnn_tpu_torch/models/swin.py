"""Swin Transformer backbone (T/S/B) emitting {res2..res5} for the FPN.

Port of ``openset_rcnn_tpu/models/swin.py:42-255`` (Liu et al. 2021, as
mmdet composes it): a 4x4 patch embed, four stages of shifted-window
attention blocks with patch-merging downsamples, and a LayerNorm on each
stage output. Stage outputs have strides 4/8/16/32 and widths C..8C.

Tokens run as (B, H, W, C); the outputs are NCHW in ``channels_last``
memory, which the port's ``FPN`` consumes. Module and parameter names follow
the JAX tree (``patch_embed``, ``stage{s}_block{b}.attn.rel_bias_table``,
``downsample{s}.reduction`` ...), so ``utils/jax_params.py`` maps one onto
the other by name, and the optimizer's frozen-stage rule (``stem_*``,
``res{s}_block*``) matches no Swin parameter, as in JAX.

Numerics, as the JAX module computes them: LayerNorm statistics in f32;
the attention logits in f32 (JAX scales q by a numpy f32 scalar, which
promotes a bf16 q, so the q.k product is taken in f32 from bf16 q and k),
the relative-position bias and the shift mask added in f32, softmax in f32,
then the probabilities cast to v's dtype; exact GELU.

Stochastic depth: ``forward(x, drop_path=masks)`` takes per-sample keep
masks, (2 * blocks, B) in call order (each block's attention branch, then
its MLP branch); without masks it is off (inference).

Stages: ``resolution_stages()`` gives the four resolution stages
(res2..res5, each ending after its output norm) as separate calls, so the
serving path can mark and capture each on its own; ``forward`` runs the
same calls in turn.
Counters (``utils/tracing.py``, on each call that runs the Python code):
``swin.tokens``, the tokens entering attention blocks, and
``swin.window_tokens``, the tokens those blocks attend over once padded to
window multiples.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import tracing
from .resnet import Conv2d
from .transformer import LayerNorm, Linear, drop_path, reset_transformer_parameters, same_pad

# size -> (embed_dim, depths, num_heads)
SWIN_VARIANTS = {
    "T": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "S": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "B": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
}
EPS = 1e-5


def _rel_pos_index(w: int) -> np.ndarray:
    """(w*w, w*w) gather index into the (2w-1)^2 bias table (torch Swin's
    ``relative_position_index``). Copy of ``openset_rcnn_tpu/models/swin.py:51-58``."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))  # (2, w, w)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, L, L)
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def _shift_mask(hp: int, wp: int, w: int, shift: int) -> np.ndarray:
    """(nW, L, L) additive attention mask of the shifted windows on the
    PADDED grid: 9 region ids from the {(0,-w), (-w,-shift), (-shift,None)}
    slice product; pairs from different regions get -100. Copy of
    ``openset_rcnn_tpu/models/swin.py:61-77``."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // w, w, wp // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)  # (nW, L)
    diff = win[:, :, None] != win[:, None, :]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


def _partition(x: torch.Tensor, w: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B, nW, w*w, C), zero-padded up to multiples of w."""
    B, H, W, C = x.shape
    ph, pw = (w - H % w) % w, (w - W % w) % w
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, -1, w * w, C), (Hp, Wp)


def _unpartition(x: torch.Tensor, w: int, hw_pad: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    Hp, Wp = hw_pad
    B = x.shape[0]
    x = x.reshape(B, Hp // w, Wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, : hw[0], : hw[1]]


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = float(np.float32(1.0 / np.sqrt(dim // num_heads)))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(_rel_pos_index(window).reshape(-1).astype(np.int64)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (B, nW, L, C); mask: (nW, L, L) f32 or None."""
        B, nW, L, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(B, nW, L, 3, h, C // h).permute(3, 0, 1, 4, 2, 5)  # (3, B, nW, h, L, d)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q.float() * self.scale, k.float().transpose(-1, -2))  # (B, nW, h, L, L) f32
        bias = self.rel_bias_table[self.rel_index].reshape(L, L, h).permute(2, 0, 1)
        attn = attn + bias.float()
        if mask is not None:
            attn = attn + mask[None, :, None]
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).permute(0, 1, 3, 2, 4).reshape(B, nW, L, C)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, drop_path: float,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift, self.drop_path = window, shift, drop_path
        self.norm1 = LayerNorm(dim, EPS)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = LayerNorm(dim, EPS)
        self.mlp_fc1 = Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H, W, C); mask: the stage's shift mask (used by the shifted
        blocks); keep: (2, B) keep masks of the two branches."""
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        y = self.norm1(x)
        # pad to window multiples FIRST, then roll the padded grid (the
        # mask models the wrap seam at Hp - shift)
        ph, pw = (w - H % w) % w, (w - W % w) % w
        if ph or pw:
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y, hw_pad = _partition(y, w)  # the pad is a no-op: already multiples
        y = self.attn(y, mask if s else None)
        y = _unpartition(y, w, hw_pad, (Hp, Wp))
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        y = y[:, :H, :W]
        x = x + drop_path(y, None if keep is None else keep[0], self.drop_path)
        z = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + drop_path(z, None if keep is None else keep[1], self.drop_path)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        if H % 2 or W % 2:  # the torch implementation pads odd sides
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        # torch's concat order: [0::2, 0::2], [1::2, 0::2], [0::2, 1::2], [1::2, 1::2]
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """Swin-{T,S,B} trunk -> {res2: C@s4, res3: 2C@s8, res4: 4C@s16, res5: 8C@s32}.

    ``embed_dim``, ``depths`` and ``num_heads`` override the variant's (test
    sizes)."""

    def __init__(self, size: str = "T", window: int = 7, compute_dtype: torch.dtype = torch.float32,
                 drop_path_rate: float = 0.0, embed_dim: Optional[int] = None,
                 depths: Optional[Sequence[int]] = None, num_heads: Optional[Sequence[int]] = None):
        super().__init__()
        C, d, h = SWIN_VARIANTS[size]
        embed_dim, depths, num_heads = embed_dim or C, tuple(depths or d), tuple(num_heads or h)
        self.compute_dtype, self.depths, self.window = compute_dtype, depths, window
        self.patch_embed = Conv2d(3, embed_dim, 4, stride=4)
        self.patch_norm = LayerNorm(embed_dim, EPS)
        # the torch recipe's per-block drop-path rates, linspace(0, rate, total)
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.out_channels: List[int] = []
        dim, blk = embed_dim, 0
        for s, depth in enumerate(depths):
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", SwinBlock(dim, num_heads[s], window,
                                                                0 if b % 2 == 0 else window // 2, rates[blk]))
                blk += 1
            self.add_module(f"out_norm{s}", LayerNorm(dim, EPS))
            self.out_channels.append(dim)
            if s < len(depths) - 1:
                self.add_module(f"downsample{s}", PatchMerging(dim))
                dim *= 2
        self.branch_rates = [r for r in rates for _ in range(2)]  # (attention, MLP) per block
        self._masks: Dict[tuple, torch.Tensor] = {}

    def shift_mask(self, H: int, W: int, device: torch.device) -> torch.Tensor:
        """The shift mask of a stage of H x W tokens (its padded grid), on
        ``device``, made once."""
        w = self.window
        key = (H + (w - H % w) % w, W + (w - W % w) % w, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_shift_mask(key[0], key[1], w, w // 2)).to(device)
        return self._masks[key]

    def stage(self, s: int, x: torch.Tensor, drop_path: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Resolution stage ``s``: the patch embed (``s`` 0, on NCHW images)
        or the previous stage's patch merging (on its (B, H, W, C) tokens),
        then the stage's blocks and its output norm. Returns (the tokens
        after the blocks, ``res{s + 2}`` as NCHW). Counts the tokens that
        enter its blocks (``swin.tokens``) and those they attend over once
        padded to window multiples (``swin.window_tokens``)."""
        if s == 0:
            x = x.to(self.compute_dtype)
            x = self.patch_embed(same_pad(x, 4, 4)).permute(0, 2, 3, 1)  # (B, H, W, C)
            x = self.patch_norm(x)
        else:
            x = getattr(self, f"downsample{s - 1}")(x)
        B, H, W, _ = x.shape
        w, depth, blk = self.window, self.depths[s], sum(self.depths[:s])
        tracing.count("swin.tokens", depth * B * H * W)
        tracing.count("swin.window_tokens", depth * B * (-(-H // w) * w) * (-(-W // w) * w))
        mask = self.shift_mask(H, W, x.device)
        for b in range(depth):
            keep = None if drop_path is None else drop_path[2 * (blk + b): 2 * (blk + b) + 2]
            x = getattr(self, f"stage{s}_block{b}")(x, mask, keep)
        return x, getattr(self, f"out_norm{s}")(x).permute(0, 3, 1, 2)

    def resolution_stages(self) -> List[Tuple[str, Callable[..., tuple]]]:
        """The resolution stages in order, as (``res2``..``res5``, fn):
        ``fn(x, feats)`` runs ``stage`` on ``x`` (the images, then the
        previous stage's tokens) and returns (its tokens, ``feats`` with its
        output added). ``models/detector.py::inference_stages`` runs each as
        a stage of its own."""
        def run(s):
            def fn(x, feats):
                x, out = self.stage(s, x)
                return x, {**feats, f"res{s + 2}": out}
            return fn

        return [(f"res{s + 2}", run(s)) for s in range(len(self.depths))]

    def forward(self, x: torch.Tensor, drop_path: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: NCHW images; ``drop_path``: (2 * blocks, B) keep masks or None."""
        outs = {}
        for s in range(len(self.depths)):
            x, outs[f"res{s + 2}"] = self.stage(s, x, drop_path=drop_path)
        return outs

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers: lecun_normal Dense and Conv kernels, zero
        biases, LayerNorms at identity, the bias tables truncated normal
        (std 0.02, cut at two)."""
        reset_transformer_parameters(self, generator)
        for m in self.modules():
            if isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.rel_bias_table, std=0.02, a=-0.04, b=0.04, generator=generator)
