"""Optimizer, learning-rate schedule and frozen parameters.

Port of ``openset_rcnn_tpu/engine/optimizer.py:21-111``: SGD with momentum
and weight decay, a linear warm-up then x``gamma`` steps (d2's
``WarmupMultiStepLR``), optional gradient clipping.

``torch.optim.SGD`` computes what the JAX chain ``add_decayed_weights ->
trace -> scale_by_schedule -> scale(-1)`` computes: the decay is added to the
gradient before the momentum buffer (a zero buffer's first step is the
update itself), and the step's learning rate scales the buffer. The caller
sets the learning rate of step k, ``schedule(k)``, before the update.

Frozen parameters: the JAX package freezes by a mask over the parameter
tree and stops their gradients (``engine/train_state.py:44-63``). Here
FrozenBN statistics and affines are buffers already, and the parameters of
the stages below ``FREEZE_AT`` (1 = stem, 2 = stem + res2) get
``requires_grad_(False)``, so their gradients are never computed and the
optimizer never sees them.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def _frozen_stage_prefixes(freeze_at: int) -> List[str]:
    out = ["backbone.stem_"] if freeze_at >= 1 else []
    out += [f"backbone.res{s}_block" for s in range(2, freeze_at + 1)]
    return out


def trainable_mask(names: Iterable[str], freeze_at: int) -> Dict[str, bool]:
    """{parameter name: trainable} for the port's parameter names (the JAX
    tree's paths joined by "."): the stem and the ``res2``..``res{freeze_at}``
    blocks are frozen."""
    prefixes = _frozen_stage_prefixes(freeze_at)
    return {n: not any(n.startswith(p) for p in prefixes) for n in names}


def freeze(model: nn.Module, freeze_at: int) -> List[nn.Parameter]:
    """Freeze the stages below ``freeze_at`` in place; the trainable
    parameters, in ``named_parameters`` order."""
    mask = trainable_mask([n for n, _ in model.named_parameters()], freeze_at)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return [p for name, p in model.named_parameters() if mask[name]]


def warmup_multistep_schedule(
    base_lr: float,
    steps: Sequence[int],
    gamma: float,
    warmup_iters: int,
    warmup_factor: float,
    warmup_method: str = "linear",
) -> Callable[[int], float]:
    """lr(step), computed in float32 operation for operation as the JAX
    schedule does, so both sides use the same learning rate bit for bit."""
    f32 = np.float32
    steps = tuple(int(s) for s in steps)

    def schedule(count: int) -> float:
        it = f32(count)
        if warmup_method == "constant":
            ramp = f32(warmup_factor)
        else:  # linear (d2 default)
            ramp = f32(warmup_factor) + f32(1.0 - warmup_factor) * it / f32(max(warmup_iters, 1))
        warm = ramp if it < warmup_iters else f32(1.0)
        decay = f32(1.0)
        for s in steps:
            decay = decay * (f32(gamma) if it >= s else f32(1.0))
        return float(f32(base_lr) * warm * decay)

    return schedule


def clip_gradients(params: Sequence[nn.Parameter], clip_type: str, clip_value: float,
                   sharded: Sequence[bool] = (), model_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> None:
    """optax's ``clip`` (elementwise, "value") or ``clip_by_global_norm``
    ("norm") over the trainable parameters' gradients, in place.

    Under tensor parallelism (``sharded[i]``: ``params[i]`` holds a model
    group's shard), the global norm sums each sharded gradient's squares over
    the model group (``model_sum``) once and each whole one's once."""
    live = [(p.grad, bool(sharded) and sharded[i]) for i, p in enumerate(params) if p.grad is not None]
    grads = [g for g, _ in live]
    if clip_type == "norm":
        squares = [torch.sum(g * g) for g in grads]
        parts = [i for i, (_, part) in enumerate(live) if part]
        if parts:
            summed = model_sum(torch.stack([squares[i] for i in parts]))
            for j, i in enumerate(parts):
                squares[i] = summed[j]
        norm = torch.sqrt(sum(squares))
        for g in grads:
            g.copy_(torch.where(norm < clip_value, g, g / norm * clip_value))
    else:
        for g in grads:
            g.clamp_(-clip_value, clip_value)


def build_optimizer(cfg, model: nn.Module) -> Tuple[torch.optim.SGD, Callable[[int], float], List[nn.Parameter]]:
    """(SGD over the trainable parameters, lr schedule, those parameters);
    freezes the stages below ``MODEL.BACKBONE.FREEZE_AT`` in place."""
    s = cfg.SOLVER
    schedule = warmup_multistep_schedule(s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_ITERS, s.WARMUP_FACTOR,
                                         s.WARMUP_METHOD)
    params = freeze(model, cfg.MODEL.BACKBONE.FREEZE_AT)
    opt = torch.optim.SGD(params, lr=schedule(0), momentum=s.MOMENTUM, weight_decay=s.WEIGHT_DECAY)
    return opt, schedule, params
