"""Balanced random subsampling with fixed shapes.

Port of ``openset_rcnn_tpu/ops/sampling.py:18-123``: rank the candidates by
i.i.d. uniform keys and keep the ranks below a quota, which is a uniform
random subset of the quota's size. Leading batch dims are allowed.

Randomness: each function takes its uniform draws as a tensor
(``uniforms``), so a test can feed it the very numbers the JAX version drew
from its key tree; a training step draws them all in one place
(``models.detector.sampling_draws``). Ties among the draws keep JAX's order: ``top_k`` and
the stable ``argsort`` put the lower index first (``ops/topk.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .topk import stable_topk


def draw_uniforms(shape, device, generator: torch.Generator) -> torch.Tensor:
    """U[0, 1) f32 draws from ``generator``, which must live on ``device``."""
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def _rank_within(mask: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Random rank of each element among the mask's members (0-based);
    non-members rank after every member."""
    key = torch.where(mask, r, torch.full_like(r, 2.0))
    order = torch.sort(key, dim=-1, stable=True).indices
    n = mask.shape[-1]
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(n, device=mask.device).expand_as(order))
    return ranks


def _random_subset_mask(mask: torch.Tensor, quota: torch.Tensor, cap: int, r: torch.Tensor) -> torch.Tensor:
    """Mask of a uniform random subset of min(quota, cap, #mask) members:
    the ``cap`` largest draws among members, of which the first ``quota``."""
    vals = torch.where(mask, r, torch.full_like(r, -1.0))
    k = min(cap, mask.shape[-1])
    _, top_idx = stable_topk(vals, k)
    slot_ok = torch.arange(k, device=mask.device) < quota[..., None]
    out = torch.zeros_like(mask).scatter_(-1, top_idx, slot_ok)
    return out & mask  # padding slots (draw -1) stay False


def subsample_labels(
    labels: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
    uniforms: torch.Tensor,
) -> torch.Tensor:
    """``labels`` (..., N) in {-1, 0, 1} with the unsampled entries set to -1.

    d2 semantics: num_pos = min(#pos, int(num_samples * frac)),
    num_neg = min(#neg, num_samples - num_pos). ``uniforms`` (..., 2, N):
    the positives' draws, then the negatives'.
    """
    pos, neg = labels == 1, labels == 0
    num_pos = torch.clamp(pos.sum(-1), max=int(num_samples * positive_fraction))
    num_neg = torch.minimum(neg.sum(-1), num_samples - num_pos)
    pos_keep = _random_subset_mask(pos, num_pos, num_samples, uniforms[..., 0, :])
    neg_keep = _random_subset_mask(neg, num_neg, num_samples, uniforms[..., 1, :])
    out = torch.full(labels.shape, -1, dtype=torch.int32, device=labels.device)
    out = torch.where(pos_keep, torch.ones_like(out), out)
    return torch.where(neg_keep, torch.zeros_like(out), out)


class SampledIndices(NamedTuple):
    indices: torch.Tensor  # (..., num_samples) int64 gather indices
    is_pos: torch.Tensor   # (..., num_samples) bool
    valid: torch.Tensor    # (..., num_samples) bool (False = padding slot)


def sample_balanced_indices(
    pos_mask: torch.Tensor,
    neg_mask: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
    uniforms: torch.Tensor,
) -> SampledIndices:
    """Exactly ``num_samples`` gather indices: min(#pos, frac * S) positives,
    then negatives, then padding slots (valid False). ``uniforms``
    (..., 3, N): the positives' ranks, the negatives' ranks, the order's
    tie-break."""
    num_pos = torch.clamp(pos_mask.sum(-1), max=int(num_samples * positive_fraction))
    num_neg = torch.minimum(neg_mask.sum(-1), num_samples - num_pos)
    pos_keep = pos_mask & (_rank_within(pos_mask, uniforms[..., 0, :]) < num_pos[..., None])
    neg_keep = neg_mask & (_rank_within(neg_mask, uniforms[..., 1, :]) < num_neg[..., None])
    # selected positives first, then selected negatives, then the rest;
    # a random tie-break inside each class
    cls = torch.where(pos_keep, 0.0, torch.where(neg_keep, 1.0, 2.0))
    order = torch.sort(cls + uniforms[..., 2, :] * 0.5, dim=-1, stable=True).indices
    slot = torch.arange(num_samples, device=pos_mask.device)
    return SampledIndices(
        indices=order[..., :num_samples],
        is_pos=slot < num_pos[..., None],
        valid=slot < (num_pos + num_neg)[..., None],
    )
