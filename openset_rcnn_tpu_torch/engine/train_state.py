"""The training step: forward, six losses, backward and the SGD update.

Port of ``openset_rcnn_tpu/engine/train_state.py:20-87``. ``Trainer`` is the
entry point: the model on the GPU unless the caller names a device, its
frozen stages, the optimizer, anchors per image bucket, and ``step(batch)``.

Randomness: the samplers and the backbone's drop-path masks of step k draw
from a generator seeded from (seed, k), so a run resumed at step k draws
what the uninterrupted run drew (the role of ``jax.random.fold_in(rng,
step)`` at ``train_state.py:73``). Every rank of a data-parallel layout
seeds the same generator, draws the global batch's uniforms and keeps its
own images' rows (``Trainer.sampling_draws``).

Numerics: ``Trainer.step`` runs its forward, backward and update under
``device.entry_numerics(deterministic=True)``: f32 without TF32, bf16
matmuls summing in f32, and cuDNN's deterministic algorithms, so two steps
from one state on one batch give bitwise equal parameters, as the JAX
package's training does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import entry_numerics, resolve_device
from ..models.detector import (Mark, ModelSpec, OpensetRCNN, build_model, compute_anchors, sampling_draws,
                               training_losses_and_stats)
from ..ops.losses import LOCAL, LocalSum
from ..parallel.mesh import SINGLE, Layout, param_sharding
from ..structures import GroundTruth, ImageBatch
from .optimizer import build_optimizer, clip_gradients


@dataclass
class TrainState:
    step: int
    model: OpensetRCNN
    optimizer: torch.optim.SGD


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The sampling generator of ``step``: a function of (seed, step) only."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class StepLosses(nn.Module):
    """The forward of a training step, (losses, scalars), as one module:
    ``DistributedDataParallel`` prepares its gradient reduction in its own
    ``forward``, and ``training_losses_and_stats`` calls the model's parts
    directly, so the step wraps this module, never the model."""

    def __init__(self, model: OpensetRCNN, spec: ModelSpec, global_sum: LocalSum = LOCAL):
        super().__init__()
        self.model, self.spec, self.global_sum = model, spec, global_sum

    def forward(self, batch: ImageBatch, anchors: torch.Tensor, level_sizes: List[int],
                uniforms: Mapping[str, torch.Tensor], mark: Mark = None):
        return training_losses_and_stats(self.model, batch, self.spec, anchors, level_sizes, uniforms=uniforms,
                                         mark=mark, global_sum=self.global_sum)


def make_train_step(
    step_losses: nn.Module,
    schedule: Callable[[int], float],
    trainable: List[nn.Parameter],
    clip: Optional[Tuple[str, float]] = None,
    layout: Layout = SINGLE,
    sharded: Sequence[bool] = (),
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``train_step(state, batch, anchors, level_sizes, uniforms,
    mark=None)``: one update of ``state`` in place; returns the
    losses, the training scalars, ``total_loss`` and ``lr``, on the device.
    ``step_losses``: a ``StepLosses``, or one wrapped in
    ``DistributedDataParallel`` over ``layout``'s data group; ``sharded``:
    which of ``trainable`` hold a model group's shard. ``mark`` is
    called after each stage of the forward (see
    ``training_losses_and_stats``), then after "backward" and "optimizer".

    Under a data group of n ranks each rank's losses are its share of the
    global batch's (``training_losses_and_stats``); the backward takes n
    times their sum, so DDP's mean of the ranks' gradients is the gradient of
    the global loss, and the losses written are summed over the group."""
    n = layout.data
    data_sum = layout.data_sum

    def train_step(state: TrainState, batch: ImageBatch, anchors: torch.Tensor, level_sizes: List[int],
                   uniforms: Mapping[str, torch.Tensor], mark: Mark = None):
        lr = schedule(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        losses, stats = step_losses(batch, anchors, level_sizes, uniforms, mark)
        total = sum(losses.values())
        (total * n if n > 1 else total).backward()
        if mark:
            mark("backward")
        if clip is not None:
            clip_gradients(trainable, *clip, sharded=sharded, model_sum=layout.model_sum)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        if mark:
            mark("optimizer")
        values = [v.detach() for v in losses.values()] + [total.detach()]
        if n > 1:
            values = list(data_sum(torch.stack(values)))
        metrics = dict(zip(losses, values[:-1]))
        metrics.update(stats)
        metrics["total_loss"] = values[-1]
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32, device=total.device)
        return metrics

    return train_step


def trainable_names(model: nn.Module) -> List[str]:
    """The names of the model's trainable parameters, in the optimizer's
    order."""
    return [n for n, p in model.named_parameters() if p.requires_grad]


class Trainer:
    """Training on one device, for every backbone the port builds, alone or
    as one rank of a data- and model-parallel layout.

    Args:
        cfg: a CfgNode (e.g. configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml
            merged into the defaults).
        device: the GPU unless given; with no GPU and no explicit device it
            raises (there is no CPU fallback). ``"cpu"`` runs the plain
            PyTorch versions of the kernels.
        state_dict: weights in the port's naming; a seeded random init when
            None.
        seed: seed of that init and of the per-step sampling generators.
        layout: this rank's ``parallel.mesh.Layout`` (``make_layout``); the
            default is one process. Under a process group the step is wrapped
            in ``DistributedDataParallel`` over the data group (FrozenBN's
            buffers never change, so none are broadcast), and with
            ``layout.model`` > 1 the box head is tensor-parallel.
            ``TrainState.model`` stays the unwrapped model, so state dicts
            keep their names.
    """

    def __init__(self, cfg, device: Optional[Union[str, torch.device]] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                 layout: Layout = SINGLE):
        self.device = resolve_device(device)
        self.spec = ModelSpec.from_cfg(cfg)
        self.seed = seed
        self.layout = layout
        model = build_model(self.spec, self.device, state_dict, seed).train()
        if layout.model > 1:
            model.box_head.shard(layout)
        optimizer, self.schedule, trainable = build_optimizer(cfg, model)
        clip = None
        if cfg.SOLVER.CLIP_GRADIENTS.ENABLED:
            clip = (cfg.SOLVER.CLIP_GRADIENTS.get("CLIP_TYPE", "value"), cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE)
        self.state = TrainState(step=0, model=model, optimizer=optimizer)
        step_losses = StepLosses(model, self.spec, layout.data_sum)
        if layout.distributed:
            from torch.nn.parallel import DistributedDataParallel

            step_losses = DistributedDataParallel(step_losses, process_group=layout.data_group,
                                                  broadcast_buffers=False)
        sharded = [s is not None for s in param_sharding(trainable_names(model)).values()]
        self._train_step = make_train_step(step_losses, self.schedule, trainable, clip, layout, sharded)
        self._anchors: Dict[Tuple[int, int], Tuple[torch.Tensor, List[int]]] = {}

    @property
    def model(self) -> OpensetRCNN:
        return self.state.model

    def anchors(self, bucket: Tuple[int, int]) -> Tuple[torch.Tensor, List[int]]:
        """(R, 4) anchors on the device and the per-level counts of a bucket."""
        if bucket not in self._anchors:
            anchors, level_sizes = compute_anchors(self.spec, bucket)
            self._anchors[bucket] = (torch.from_numpy(anchors).to(self.device), level_sizes)
        return self._anchors[bucket]

    def sampling_draws(self, batch: ImageBatch, num_anchors: int, level_sizes: List[int],
                       generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The step's draws (``detector.sampling_draws``) for the global
        batch, of which this rank keeps its own images' rows: so a
        data-parallel step samples exactly as the one-process step at the
        same global batch."""
        b, n, d = batch.images.shape[0], self.layout.data, self.layout.data_index
        draws = sampling_draws(self.model, self.spec, b * n, num_anchors, level_sizes, batch.gt.boxes.shape[1],
                               generator, batch.images.device)
        rows = slice(d * b, (d + 1) * b)
        return {k: (v[:, rows] if k == "drop_path" else v[rows]).contiguous() for k, v in draws.items()}

    def step(self, batch: ImageBatch, uniforms: Optional[Mapping[str, torch.Tensor]] = None,
             mark: Mark = None) -> Dict[str, torch.Tensor]:
        """One SGD step on ``batch`` (images padded to one bucket, with each
        image's true (h, w) and padded GT; under a data group, this rank's
        share of the global batch); the metrics stay on the device and are
        the global batch's. ``uniforms`` replaces the step's draws
        (``sampling_draws``; all of them, for this rank's images)."""
        dev = self.device
        batch = ImageBatch(
            images=batch.images.to(dev),
            image_hw=batch.image_hw.to(dev, torch.float32),
            gt=GroundTruth(batch.gt.boxes.to(dev, torch.float32), batch.gt.classes.to(dev),
                           batch.gt.valid.to(dev)),
        )
        anchors, level_sizes = self.anchors(tuple(batch.images.shape[1:3]))
        if uniforms is None:
            uniforms = self.sampling_draws(batch, anchors.shape[0], level_sizes,
                                           step_generator(self.seed, self.state.step, dev))
        with entry_numerics(deterministic=True):
            return self._train_step(self.state, batch, anchors, level_sizes, uniforms, mark)
