"""ViTDet's plain-ViT backbones with a simple feature pyramid (Li et al.
2022): ViT-B, and EVA-02 (Fang et al., arXiv:2303.11331) in the same frame.

Port of ``openset_rcnn_tpu/models/vit.py:34-239``: a 16x16 patch embed, a
learnable position table kept at its native grid (14x14 for ViT-B) and
resized to the runtime patch grid inside the forward (the same bicubic
matrices, applied as ``W_h @ table @ W_w.T`` in f32), blocks of windowed
attention (14x14 for ViT-B) with global attention in the blocks
``global_blocks`` names (every third by default), a final LayerNorm, and
the simple pyramid: two stride-2 deconvolutions up to P2/P3, P4 as is, a
2x2 max-pool down to P5, each projected to 256 channels (1x1 conv,
LayerNorm, 3x3 conv, LayerNorm), and P6 = P5[::2, ::2]. Returns {p2..p6}
NCHW in ``channels_last`` memory, as the port's ``FPN`` does, so the heads
are unchanged.

ViTDet's block: ``x + attn(norm1(x))`` with one biased qkv projection, then
``x + mlp_fc2(GELU(mlp_fc1(norm2(x))))``. EVA-02's block (``rope`` given;
``EVA02SimpleFPN``): q and v have biases (``q_bias``, ``v_bias``), k has
none; 2D rotary positions rotate q and k of every head before q.k
(``rope_tables``, ``apply_rope``); the MLP is SwiGLU with a LayerNorm inside
(sub-LN): ``mlp.w3(mlp.ffn_ln(silu(mlp.w1(x)) * mlp.w2(x)))``.

RoPE (EVA's ``VisionRotaryEmbeddingFast``): head width d, theta_k =
10000^(-2k / (d/2)) for k < d/4; a token at (row r, column c) has the phase
phi[2k] = phi[2k+1] = r' theta_k in the first half of the head and c'
theta_k in the second, with r' = r * pt / ft (c' likewise): in a window (ft
the window) r and c are the positions inside it, in a global block (ft
``rope_global_ft``) those of the grid present. Then x -> x cos(phi) +
rot(x) sin(phi), rot taking each pair (x[2m], x[2m+1]) to (-x[2m+1],
x[2m]), in f32; computed as x cos(phi) plus the pair-swapped x times a sin
table with rot's sign folded in, both tables made once per grid and device
(on the first, eager call, so a CUDA graph reads them in place).

Numerics, as the JAX module: q is scaled by the scale cast to q's dtype,
the logits are the q.k product in the compute dtype, then softmax in f32 and
the probabilities cast back; LayerNorm statistics in f32 (eps 1e-6); exact
GELU. Stochastic depth as in ``swin.py``: keep masks (2 * depth, B) in call
order, or off.

Counters (``utils/tracing.py``, once per ``trunk`` call that runs the Python
code, summed over the blocks and the batch): ``vit.window_tokens``, the
tokens entering windowed attention, padding included; ``vit.global_tokens``,
those entering global attention; ``vit.attn_logits``, the logits
materialised (x heads); ``vit.rope_rows``, the q and k rows rotated, one a
head and token (0 on ViT-B).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import tracing
from .resnet import Conv2d
from .transformer import ConvTranspose2d, LayerNorm, Linear, drop_path, reset_transformer_parameters, same_pad

GLOBAL_EVERY = 3  # every third block attends globally (ViTDet-B: 4 of 12)
EPS = 1e-6
ROPE_THETA = 10000.0

Rope = Tuple[torch.Tensor, torch.Tensor]  # (cos, sign-folded sin) tables, (tokens, head width)


class EVA02Config(NamedTuple):
    """``MODEL.EVA02``; the defaults are EVA-02-L's in the ViTDet frame."""

    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_hidden: int = 2730  # int(1024 * 4 * 2 / 3)
    window_size: int = 16
    global_blocks: Tuple[int, ...] = (2, 5, 8, 11, 14, 17, 20, 23)
    pos_grid: int = 16
    rope_pt: int = 16
    rope_global_ft: int = 96
    drop_path_rate: float = 0.0

    @staticmethod
    def from_cfg(node) -> "EVA02Config":
        return EVA02Config(
            embed_dim=node.EMBED_DIM, depth=node.DEPTH, num_heads=node.NUM_HEADS, mlp_hidden=node.MLP_HIDDEN,
            window_size=node.WINDOW_SIZE, global_blocks=tuple(node.GLOBAL_BLOCKS), pos_grid=node.POS_GRID,
            rope_pt=node.ROPE_PT, rope_global_ft=node.ROPE_GLOBAL_FT, drop_path_rate=float(node.DROP_PATH_RATE))


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


def rope_tables(rows: torch.Tensor, cols: torch.Tensor, head_dim: int) -> Rope:
    """(cos phi, sin phi with rot's sign folded in), each (len(rows) *
    len(cols), head_dim) f32, for the tokens at the scaled positions
    ``rows`` x ``cols`` in row-major order (see the module docstring)."""
    half = head_dim // 2
    theta = ROPE_THETA ** (-torch.arange(0, half, 2, dtype=torch.float64) / half)
    pr = (rows.double()[:, None] * theta).repeat_interleave(2, -1)  # (H, half)
    pc = (cols.double()[:, None] * theta).repeat_interleave(2, -1)  # (W, half)
    phi = torch.cat((pr[:, None, :].expand(-1, len(cols), -1), pc[None, :, :].expand(len(rows), -1, -1)), -1)
    phi = phi.reshape(-1, head_dim)
    sign = torch.tensor([-1.0, 1.0], dtype=torch.float64).repeat(half)  # rot(x)[2m] = -x[2m + 1]
    return phi.cos().float(), (phi.sin() * sign).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x cos(phi) + rot(x) sin(phi) in f32, back in x's dtype: rot(x) sin(phi)
    is x with each pair swapped, times the sign-folded ``sin``."""
    xf = x.float()
    swapped = xf.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return torch.addcmul(xf * cos, swapped, sin).to(x.dtype)


class Attention(nn.Module):
    """Multi-head attention over (N, L, C) tokens. ``qv_bias``: q and v
    biased, k not (EVA-02: ``qkv`` unbiased, ``q_bias`` and ``v_bias``);
    else one bias over q, k and v (ViTDet)."""

    def __init__(self, dim: int, num_heads: int, qv_bias: bool = False):
        super().__init__()
        self.num_heads, self.qv_bias = num_heads, qv_bias
        self.scale = 1.0 / np.sqrt(dim // num_heads)
        if qv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        self.qkv = Linear(dim, 3 * dim, bias=not qv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, rope: Optional[Rope] = None) -> torch.Tensor:
        """``rope``: the tables of the L positions, or None."""
        N, L, C = x.shape
        if self.qv_bias:
            bias = torch.cat((self.q_bias, torch.zeros_like(self.q_bias), self.v_bias)).to(x.dtype)
            qkv = F.linear(x, self.qkv.weight.to(x.dtype), bias)
        else:
            qkv = self.qkv(x)
        qkv = qkv.reshape(N, L, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)  # (3, N, h, L, d)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        q = q * torch.full((), self.scale, dtype=q.dtype, device=q.device)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        return self.proj(torch.matmul(attn, v).permute(0, 2, 1, 3).reshape(N, L, C))


class SwiGLU(nn.Module):
    """EVA-02's MLP: ``w3(ffn_ln(silu(w1 x) * w2 x))``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1 = Linear(dim, hidden)
        self.w2 = Linear(dim, hidden)
        self.ffn_ln = LayerNorm(hidden, EPS)
        self.w3 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w3(self.ffn_ln(F.silu(self.w1(x)) * self.w2(x)))


class Block(nn.Module):
    """ViTDet's block, or with ``eva02`` EVA-02's (q/v biases, RoPE, SwiGLU
    with sub-LN)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, drop_path: float, mlp_hidden: int,
                 eva02: bool = False):
        super().__init__()
        self.window_size, self.drop_path, self.eva02 = window_size, drop_path, eva02  # window 0: global attention
        self.norm1 = LayerNorm(dim, EPS)
        self.attn = Attention(dim, num_heads, qv_bias=eva02)
        self.norm2 = LayerNorm(dim, EPS)
        if eva02:
            self.mlp = SwiGLU(dim, mlp_hidden)
        else:
            self.mlp_fc1 = Linear(dim, mlp_hidden)
            self.mlp_fc2 = Linear(mlp_hidden, dim)

    def counts(self, B: int, H: int, W: int) -> Tuple[int, int]:
        """(tokens entering the attention, padding included; logits) on a
        B x H x W grid."""
        w = self.window_size
        if w > 0:
            windows = B * -(-H // w) * -(-W // w)
            return windows * w * w, self.attn.num_heads * windows * (w * w) ** 2
        return B * H * W, self.attn.num_heads * B * (H * W) ** 2

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                rope: Optional[Rope] = None) -> torch.Tensor:
        """x: (B, H, W, C); keep: (2, B) keep masks of the two branches;
        rope: the tables of the attention's tokens (a window's, or the
        grid's in a global block), or None."""
        B, H, W, C = x.shape
        y = self.norm1(x)
        if self.window_size > 0:
            w = self.window_size
            y, hw_pad = _window_partition(y, w)
            y = self.attn(y.reshape(-1, w * w, C), rope)
            y = _window_unpartition(y.reshape(-1, w, w, C), w, hw_pad, (H, W))
        else:
            y = self.attn(y.reshape(B, H * W, C), rope).reshape(B, H, W, C)
        x = x + drop_path(y, None if keep is None else keep[0], self.drop_path)
        y = self.norm2(x)
        z = self.mlp(y) if self.eva02 else self.mlp_fc2(F.gelu(self.mlp_fc1(y)))
        return x + drop_path(z, None if keep is None else keep[1], self.drop_path)


def _channel_norm(ln: LayerNorm, y: torch.Tensor) -> torch.Tensor:
    """A LayerNorm over the channels of NCHW ``y``."""
    return ln(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ViTSimpleFPN(nn.Module):
    """Plain-ViT trunk + simple feature pyramid -> {p2..p6} at
    ``out_channels``; ViT-B by default.

    ``embed_dim``, ``depth``, ``num_heads``, ``window_size`` and ``pos_grid``
    override ViT-B's (test sizes); ``global_blocks`` the blocks that attend
    globally (every third when None); ``mlp_hidden`` the MLP's width (4 x
    ``embed_dim`` when None); ``rope`` (pt, global ft) selects EVA-02's block
    with its RoPE scales, None ViTDet's."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 window_size: int = 14, out_channels: int = 256, pos_grid: Tuple[int, int] = (14, 14),
                 compute_dtype: torch.dtype = torch.float32, drop_path_rate: float = 0.0,
                 global_blocks: Optional[Sequence[int]] = None, mlp_hidden: Optional[int] = None,
                 rope: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.patch_size, self.pos_grid, self.depth = patch_size, tuple(pos_grid), depth
        self.compute_dtype, self.window_size, self.rope = compute_dtype, window_size, rope
        self.head_dim = embed_dim // num_heads
        if global_blocks is None:
            global_blocks = [i for i in range(depth) if (i + 1) % GLOBAL_EVERY == 0]
        self.patch_embed = Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(*pos_grid, embed_dim))
        rates = np.linspace(0.0, drop_path_rate, depth)
        for i in range(depth):
            window = 0 if i in global_blocks else window_size
            self.add_module(f"block{i}", Block(embed_dim, num_heads, window, float(rates[i]),
                                               mlp_hidden or 4 * embed_dim, eva02=rope is not None))
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
        self._rope: Dict[tuple, Tuple[Rope, Rope]] = {}

    def _resize_matrices(self, H: int, W: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (H, W, device)
        if key not in self._resize:
            self._resize[key] = tuple(torch.from_numpy(bicubic_resize_matrix(n, m)).float().to(device)
                                      for n, m in ((H, self.pos_grid[0]), (W, self.pos_grid[1])))
        return self._resize[key]

    def _rope_tables(self, H: int, W: int, device: torch.device) -> Tuple[Rope, Rope]:
        """(the windows' tables, the H x W grid's tables), made once per
        grid and device."""
        key = (H, W, device)
        if key not in self._rope:
            pt, ft = self.rope
            w = self.window_size
            inside = torch.arange(w, dtype=torch.float64) / w * pt
            self._rope[key] = tuple(tuple(t.to(device) for t in rope_tables(rows, cols, self.head_dim))
                                    for rows, cols in ((inside, inside),
                                                       (torch.arange(H, dtype=torch.float64) / ft * pt,
                                                        torch.arange(W, dtype=torch.float64) / ft * pt)))
        return self._rope[key]

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

    def trunk(self, x: torch.Tensor, drop_path: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NCHW images -> the normed stride-16 map, NCHW (patch embed,
        positions, the blocks, the final norm); counts the attention's
        tokens, logits and rotated rows."""
        x = self.tokens(x)
        B, H, W, _ = x.shape
        window_rope, global_rope = self._rope_tables(H, W, x.device) if self.rope else (None, None)
        totals = {"vit.window_tokens": 0, "vit.global_tokens": 0, "vit.attn_logits": 0, "vit.rope_rows": 0}
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            tokens, logits = block.counts(B, H, W)
            totals["vit.window_tokens" if block.window_size else "vit.global_tokens"] += tokens
            totals["vit.attn_logits"] += logits
            totals["vit.rope_rows"] += 2 * block.attn.num_heads * tokens if self.rope else 0
            keep = None if drop_path is None else drop_path[2 * i: 2 * i + 2]
            x = block(x, keep, window_rope if block.window_size else global_rope)
        for name, n in totals.items():
            tracing.count(name, n)
        return self.norm(x).permute(0, 3, 1, 2)  # NCHW, channels_last memory

    def pyramid(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The simple pyramid over the normed stride-16 map, NCHW."""
        up2 = F.gelu(self.up2a(x))
        up4 = self.up2b(up2)
        p5 = self._project(F.max_pool2d(x, 2, 2), "p5")  # stride 32: 2x2 max-pool, VALID
        return {"p2": self._project(up4, "p2"), "p3": self._project(up2, "p3"), "p4": self._project(x, "p4"),
                "p5": p5, "p6": p5[:, :, ::2, ::2]}  # stride 64: exact subsampling, not a pool

    def forward(self, x: torch.Tensor, drop_path: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: NCHW images; ``drop_path``: (2 * depth, B) keep masks or None."""
        return self.pyramid(self.trunk(x, drop_path))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers: lecun_normal kernels (fan-in of the flax
        kernel), zero biases, LayerNorms at identity, the position table
        normal (std 0.02); EVA-02's q and v biases truncated normal (std
        0.02, cut at two), where the published init is zeros, so that they
        count on random weights."""
        reset_transformer_parameters(self, generator)
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, Attention) and m.qv_bias:
                for t in (m.q_bias, m.v_bias):
                    nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)


class EVA02SimpleFPN(ViTSimpleFPN):
    """EVA-02 of ``MODEL.EVA02`` in the ViTDet frame (EVA-02-L by default),
    with its trunk as a stage of its own: ``resolution_stages()`` gives
    ``trunk`` (patch embed, positions, the blocks, the final norm), so the
    serving path marks and captures it apart from the pyramid, which
    ``models/detector.py::backbone_stages`` runs as the last stage."""

    def __init__(self, config: EVA02Config = EVA02Config(), compute_dtype: torch.dtype = torch.float32):
        c = config
        if c.embed_dim % (4 * c.num_heads):
            raise ValueError(f"MODEL.EVA02: RoPE turns pairs in both halves of a head, so the head width "
                             f"must be a multiple of 4, not {c.embed_dim} / {c.num_heads}")
        super().__init__(embed_dim=c.embed_dim, depth=c.depth, num_heads=c.num_heads, window_size=c.window_size,
                         pos_grid=(c.pos_grid, c.pos_grid), compute_dtype=compute_dtype,
                         drop_path_rate=c.drop_path_rate, global_blocks=c.global_blocks, mlp_hidden=c.mlp_hidden,
                         rope=(c.rope_pt, c.rope_global_ft))
        self.config = c

    def resolution_stages(self) -> List[Tuple[str, Callable[..., tuple]]]:
        """[("trunk", fn)]: ``fn(x, feats)`` runs ``trunk`` on the images
        and returns (the normed stride-16 map, ``feats``)."""
        return [("trunk", lambda x, feats: (self.trunk(x), feats))]
