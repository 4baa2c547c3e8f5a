"""The training step: forward, six losses, backward and the SGD update.

Port of ``openset_rcnn_tpu/engine/train_state.py:20-87``. ``Trainer`` is the
entry point: the model on the GPU unless the caller names a device, its
frozen stages, the optimizer, anchors per image bucket, and ``step(batch)``.

Randomness: the samplers of step k draw from a generator seeded from
(seed, k), so a run resumed at step k draws what the uninterrupted run drew
(the role of ``jax.random.fold_in(rng, step)`` at ``train_state.py:73``).

Numerics: ``Trainer.step`` runs its forward, backward and update under
``device.entry_numerics(deterministic=True)``: f32 without TF32, bf16
matmuls summing in f32, and cuDNN's deterministic algorithms, so two steps
from one state on one batch give bitwise equal parameters, as the JAX
package's training does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import entry_numerics, resolve_device
from ..models.detector import Mark, ModelSpec, OpensetRCNN, build_model, compute_anchors, training_losses_and_stats
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


def make_train_step(
    spec: ModelSpec,
    schedule: Callable[[int], float],
    trainable: List[nn.Parameter],
    clip: Optional[Tuple[str, float]] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``train_step(state, batch, anchors, level_sizes, generator=None,
    uniforms=None, mark=None)``: one update of ``state`` in place; returns the
    losses, the training scalars, ``total_loss`` and ``lr``, on the device.
    ``mark`` is called after each stage of the forward (see
    ``training_losses_and_stats``), then after "backward" and "optimizer"."""

    def train_step(state: TrainState, batch: ImageBatch, anchors: torch.Tensor, level_sizes: List[int],
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[Mapping[str, torch.Tensor]] = None, mark: Mark = None):
        lr = schedule(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        losses, stats = training_losses_and_stats(state.model, batch, spec, anchors, level_sizes,
                                                  generator=generator, uniforms=uniforms, mark=mark)
        total = sum(losses.values())
        total.backward()
        if mark:
            mark("backward")
        if clip is not None:
            clip_gradients(trainable, *clip)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        if mark:
            mark("optimizer")
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(stats)
        metrics["total_loss"] = total.detach()
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32, device=total.device)
        return metrics

    return train_step


class Trainer:
    """R50-FPN training on one device.

    Args:
        cfg: a CfgNode (e.g. configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml
            merged into the defaults).
        device: the GPU unless given; with no GPU and no explicit device it
            raises (there is no CPU fallback). ``"cpu"`` runs the plain
            PyTorch versions of the kernels.
        state_dict: weights in the port's naming; a seeded random init when
            None.
        seed: seed of that init and of the per-step sampling generators.
    """

    def __init__(self, cfg, device: Optional[Union[str, torch.device]] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0):
        self.device = resolve_device(device)
        self.spec = ModelSpec.from_cfg(cfg)
        self.seed = seed
        model = build_model(self.spec, self.device, state_dict, seed).train()
        optimizer, self.schedule, trainable = build_optimizer(cfg, model)
        clip = None
        if cfg.SOLVER.CLIP_GRADIENTS.ENABLED:
            clip = (cfg.SOLVER.CLIP_GRADIENTS.get("CLIP_TYPE", "value"), cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE)
        self.state = TrainState(step=0, model=model, optimizer=optimizer)
        self._train_step = make_train_step(self.spec, self.schedule, trainable, clip)
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

    def step(self, batch: ImageBatch, uniforms: Optional[Mapping[str, torch.Tensor]] = None,
             mark: Mark = None) -> Dict[str, torch.Tensor]:
        """One SGD step on ``batch`` (images padded to one bucket, with each
        image's true (h, w) and padded GT); the metrics stay on the device.
        ``uniforms`` replaces the step's sampling draws (see
        ``training_losses_and_stats``)."""
        dev = self.device
        batch = ImageBatch(
            images=batch.images.to(dev),
            image_hw=batch.image_hw.to(dev, torch.float32),
            gt=GroundTruth(batch.gt.boxes.to(dev, torch.float32), batch.gt.classes.to(dev),
                           batch.gt.valid.to(dev)),
        )
        anchors, level_sizes = self.anchors(tuple(batch.images.shape[1:3]))
        generator = None if uniforms is not None else step_generator(self.seed, self.state.step, dev)
        with entry_numerics(deterministic=True):
            return self._train_step(self.state, batch, anchors, level_sizes, generator, uniforms, mark)
