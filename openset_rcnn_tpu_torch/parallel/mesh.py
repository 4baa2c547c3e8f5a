"""The ``(data, model)`` layout of a process group, and what the box head's
tensor parallelism needs.

Port of ``openset_rcnn_tpu/parallel/mesh.py``. JAX lays its devices out as a
``('data', 'model')`` mesh (``make_mesh :19-29``) and lets GSPMD partition
one program over it. The port runs one process per GPU, so its twin lays the
ranks out instead: rank = d x M + m, row-major as JAX reshapes
``devices[:data * model]``. The ranks of one data group (same m) split the
global batch and reduce their gradients through ``DistributedDataParallel``;
the ranks of one model group (same d) read the same images and split the box
head's two FCs, the parameters ``_MODEL_SHARDED`` names (``:33-37``):

- rows of ``box_head.fc1.weight`` and ``fc1.bias`` (column-parallel fc1);
- columns of ``box_head.fc2.weight`` (row-parallel fc2, its partial outputs
  summed over the model group); ``fc2.bias`` stays whole.

``shard_state_dict`` and ``gather_state_dict`` are the twins of
``put_host_tree`` and ``host_replicated_copy`` (``:126-162``): a checkpoint
holds the whole tensors in the one-process format, every rank cuts its shard
from it, and gathering is a collective of the model group.

The active-mesh registry and ``data_shard_map`` (``:59-123``) have no twin:
XLA cannot partition a ``pallas_call``, so JAX wraps each kernel call in a
``shard_map`` over the data axis, whereas each rank of the port launches its
kernels on its own local batch already.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Optional

import torch

from ..ops.losses import LocalSum

MODEL_SHARDED: Dict[str, int] = {
    "box_head.fc1.weight": 0,
    "box_head.fc1.bias": 0,
    "box_head.fc2.weight": 1,
}


def param_sharding(names: Iterable[str]) -> Dict[str, Optional[int]]:
    """{name: the dimension split over the model axis, or None when whole}."""
    return {n: MODEL_SHARDED.get(n) for n in names}


class GroupSum(LocalSum):
    """The ``global_sum`` hook of a data group: ``x`` summed over its ranks
    (a new tensor; no gradient flows through it)."""

    def __init__(self, group: Any, size: int):
        self.group, self.size = group, size

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        import torch.distributed as dist

        x = x.detach().clone()
        dist.all_reduce(x, group=self.group)
        return x


@dataclass(frozen=True)
class Layout:
    """This rank's place in the ``(data, model)`` grid. ``data_group`` is
    None without a process group (one process)."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def distributed(self) -> bool:
        return self.data_group is not None

    @property
    def data_sum(self) -> LocalSum:
        return GroupSum(self.data_group, self.data) if self.distributed else LocalSum()

    @property
    def model_sum(self) -> LocalSum:
        return GroupSum(self.model_group, self.model) if self.model > 1 else LocalSum()


SINGLE = Layout()

LAUNCH = ("launch one process per GPU: python -m openset_rcnn_tpu_torch.train --num-gpus N [--num-machines M "
          "--machine-rank r --dist-url tcp://host:port], or torchrun")


def make_layout(mesh_data: int, mesh_model: int) -> Layout:
    """The layout of ``TPU.MESH_DATA x TPU.MESH_MODEL`` over the process
    group (``MESH_DATA -1``: the group's size over ``MESH_MODEL``). Without
    a group the product must be 1; with one it must be the group's size.
    Every rank of the group must call this, in the same order."""
    import torch.distributed as dist

    if mesh_model < 1:
        raise ValueError(f"TPU.MESH_MODEL must be >= 1, not {mesh_model}")
    if not (dist.is_available() and dist.is_initialized()):
        data = 1 if mesh_data == -1 and mesh_model == 1 else mesh_data
        if data * mesh_model != 1:
            raise ValueError(f"TPU.MESH_DATA {mesh_data} x TPU.MESH_MODEL {mesh_model} asks for several processes, "
                             f"but this one has no process group: {LAUNCH}")
        return SINGLE
    world, rank = dist.get_world_size(), dist.get_rank()
    data = world // mesh_model if mesh_data == -1 else mesh_data
    if data < 1 or data * mesh_model != world:
        raise ValueError(f"TPU.MESH_DATA {mesh_data} x TPU.MESH_MODEL {mesh_model} does not lay out the group's "
                         f"{world} processes: give --num-gpus N and --num-machines M with N x M = MESH_DATA x "
                         "MESH_MODEL")
    d, m = divmod(rank, mesh_model)
    if mesh_model == 1:
        return Layout(data, 1, d, 0, dist.group.WORLD, None)
    data_group = model_group = None
    for dd in range(data):  # every rank creates every group, in one order
        group = dist.new_group([dd * mesh_model + mm for mm in range(mesh_model)])
        model_group = group if dd == d else model_group
    for mm in range(mesh_model):
        group = dist.new_group([dd * mesh_model + mm for dd in range(data)])
        data_group = group if mm == m else data_group
    return Layout(data, mesh_model, d, m, data_group, model_group)


def shard(t: torch.Tensor, dim: int, layout: Layout) -> torch.Tensor:
    """This rank's part of the whole tensor ``t`` along ``dim``."""
    if t.shape[dim] % layout.model:
        raise ValueError(f"{t.shape[dim]} does not split over a model axis of {layout.model}")
    return t.chunk(layout.model, dim)[layout.model_index].contiguous()


def gather(t: torch.Tensor, dim: int, layout: Layout) -> torch.Tensor:
    """The whole tensor from the model group's parts (a collective)."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(layout.model)]
    dist.all_gather(parts, t.contiguous(), group=layout.model_group)
    return torch.cat(parts, dim)


def shard_state_dict(state: Mapping[str, torch.Tensor], layout: Layout) -> Dict[str, torch.Tensor]:
    """A whole (one-process) state dict cut to this rank's shards."""
    if layout.model == 1:
        return dict(state)
    return {k: shard(v, MODEL_SHARDED[k], layout) if k in MODEL_SHARDED else v for k, v in state.items()}


def gather_state_dict(state: Mapping[str, torch.Tensor], layout: Layout) -> Dict[str, torch.Tensor]:
    """The whole state dict from every rank's shards (a collective of the
    model group: every rank calls it)."""
    if layout.model == 1:
        return dict(state)
    return {k: gather(v, MODEL_SHARDED[k], layout) if k in MODEL_SHARDED else v for k, v in state.items()}


def _map_momentum(optimizer_state: Mapping[str, Any], names: Iterable[str], fn) -> Dict[str, Any]:
    """``optimizer_state`` with ``fn(buffer, dim)`` applied to the momentum of
    every sharded parameter; ``names``: the optimizer's parameters in order."""
    state = dict(optimizer_state["state"])
    for i, name in enumerate(names):
        if name in MODEL_SHARDED and i in state and state[i].get("momentum_buffer") is not None:
            state[i] = {**state[i], "momentum_buffer": fn(state[i]["momentum_buffer"], MODEL_SHARDED[name])}
    return {**optimizer_state, "state": state}


def shard_optimizer_state(optimizer_state, names, layout: Layout) -> Dict[str, Any]:
    if layout.model == 1:
        return optimizer_state
    return _map_momentum(optimizer_state, names, lambda t, dim: shard(t, dim, layout))


def gather_optimizer_state(optimizer_state, names, layout: Layout) -> Dict[str, Any]:
    """The whole SGD state (a collective of the model group)."""
    if layout.model == 1:
        return optimizer_state
    return _map_momentum(optimizer_state, names, lambda t, dim: gather(t, dim, layout))


class _CopyToModelGroup(torch.autograd.Function):
    """The identity forward; the backward sums the gradient over the model
    group (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOverModelGroup(torch.autograd.Function):
    """Sums the partial outputs of a row-parallel layer over the model group;
    the backward passes the gradient on."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_group(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    return _CopyToModelGroup.apply(x, layout.model_group)


def sum_over_model_group(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    return _SumOverModelGroup.apply(x, layout.model_group)
