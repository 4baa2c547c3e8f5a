"""Top-k with the JAX tie order.

``jax.lax.top_k`` puts the lower index first among equal values; ``torch.topk``
makes no such promise. Ties do happen on the serving path: the padded canvas
gives many anchors the same centerness, and masked ``-inf`` scores tie in the
cascade. So top-k is a stable descending sort followed by a slice.
"""
from __future__ import annotations

from typing import Tuple

import torch


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices) of the k largest along the last dim; ties by index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
