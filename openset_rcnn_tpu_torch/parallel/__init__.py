"""Process queries and the host-object gather of multi-process evaluation.

The port's counterpart of ``openset_rcnn_tpu/parallel/multihost.py:21, 65``
(``num_processes``, ``gather_object``): single-process answers unless
``torch.distributed`` is initialized, and then ``all_gather_object`` over the
default group. Data-parallel training comes with the engine loop.
"""
from __future__ import annotations

from typing import Any, List


def _group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def num_processes() -> int:
    dist = _group()
    return dist.get_world_size() if dist else 1


def process_index() -> int:
    dist = _group()
    return dist.get_rank() if dist else 0


def gather_object(obj: Any) -> List[Any]:
    """A picklable host object from every process, in rank order, on every
    process (the evaluators' ``comm.gather``)."""
    dist = _group()
    if dist is None or dist.get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
