"""Checkpoint save/resume with ``torch.save``.

Port of ``openset_rcnn_tpu/engine/checkpoint.py`` (Orbax there): saves
``{"model": state_dict, "optimizer": optimizer state_dict, "step": n}`` as
``model_{step:07d}.pt`` every CHECKPOINT_PERIOD, keeps a ``last_checkpoint``
marker, and supports
  * --resume: continue from the latest checkpoint (restores the step, the
    parameters, the buffers and the SGD momentum);
  * weights-only load (``MODEL.WEIGHTS``, ``load_weights_file``): a port
    checkpoint (``.pt``), the JAX package's flat ``.npz``, or a d2/caffe2
    ``.pkl``/``.pth`` (``utils/torch_weights.py``), dispatched as
    ``openset_rcnn_tpu/engine/checkpoint.py:82-99`` does.

Under a process group (``parallel/mesh.py``) every rank calls ``save``: the
model group gathers the box head's shards, rank 0 writes the whole weights and
momentum in the one-process format, and every rank waits at a barrier until
the file is complete; ``restore`` loads the whole file on every rank and cuts
this rank's shards from it. So a checkpoint of any layout loads into any
other, a one-process run and ``--eval-only`` included.

An Orbax checkpoint directory does not load: Orbax imports JAX, which the
port never imports, and Orbax writes OCDBT/zarr3 through ``tensorstore``.
The JAX side saves its parameters as an ``.npz`` instead (see
``ORBAX_REASON``), which both packages read.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import (SINGLE, Layout, gather_optimizer_state, gather_state_dict, shard_optimizer_state,
                             shard_state_dict)

logger = logging.getLogger(__name__)

ORBAX_REASON = (
    "Orbax checkpoint directories do not load in the PyTorch port: Orbax imports JAX, which the port never "
    "imports, and it writes OCDBT/zarr3 through tensorstore. Save the JAX parameters as a flat 'a/b/c' .npz "
    "instead, which both packages read: np.savez(path, **{'/'.join(str(k.key) for k in p): np.asarray(v) "
    "for p, v in jax.tree_util.tree_flatten_with_path(params)[0]})")


class Checkpointer:
    """Saves and restores a ``train_state.TrainState`` (step, model,
    optimizer) under ``output_dir``, for this rank's ``layout``."""

    def __init__(self, output_dir: str, layout: Layout = SINGLE):
        self.dir = os.path.abspath(output_dir)
        self.layout = layout
        os.makedirs(self.dir, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, state, step: int) -> str:
        """Write ``model_{step:07d}.pt`` (every rank calls this)."""
        from ..parallel import barrier, is_main_process
        from .train_state import trainable_names

        path = os.path.join(self.dir, f"model_{step:07d}.pt")
        model = gather_state_dict(state.model.state_dict(), self.layout)
        optimizer = gather_optimizer_state(state.optimizer.state_dict(), trainable_names(state.model), self.layout)
        if is_main_process():
            tmp = path + ".tmp"
            torch.save({"model": model, "optimizer": optimizer, "step": int(step)}, tmp)
            os.replace(tmp, path)
            with open(os.path.join(self.dir, "last_checkpoint"), "w") as f:
                f.write(os.path.basename(path))
            logger.info("Saved checkpoint %s", path)
        barrier()
        return path

    # --------------------------------------------------------------- restore
    def latest_path(self) -> Optional[str]:
        marker = os.path.join(self.dir, "last_checkpoint")
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            name = f.read().strip()
        path = os.path.join(self.dir, name)
        return path if os.path.exists(path) else None

    def restore(self, state, path: Optional[str] = None):
        """Restore ``state`` in place from ``path`` (the latest checkpoint by
        default): model weights and buffers, optimizer state, step."""
        path = path or self.latest_path()
        assert path, "no checkpoint to restore"
        from .train_state import trainable_names

        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(shard_state_dict(ckpt["model"], self.layout), strict=True)
        state.optimizer.load_state_dict(shard_optimizer_state(ckpt["optimizer"], trainable_names(state.model),
                                                              self.layout))
        state.step = int(ckpt["step"])
        logger.info("Restored checkpoint %s (step=%d)", path, state.step)
        return state

    def resume_or_load(self, state, weights: str = "", resume: bool = False) -> Tuple[object, bool]:
        """d2-style policy: --resume continues from the latest checkpoint;
        otherwise load weights-only from ``weights`` if given (every rank
        reads the whole weights and keeps its shards)."""
        if resume and self.latest_path():
            return self.restore(state), True
        if weights:
            load_weights_file(weights, state.model, self.layout)
        return state, False


def load_weights_file(path: str, model: nn.Module, layout: Layout = SINGLE) -> nn.Module:
    """Load model weights into ``model``: a port checkpoint (``.pt``, its
    ``model`` entry; unknown keys raise), the JAX package's flat ``.npz``
    (``torch_weights.load_npz``), or a d2 ``.pth`` / d2 or caffe2 ``.pkl``
    (``torch_weights.convert_torch_checkpoint``). Missing keys keep their
    initialized values; shape mismatches raise. An Orbax directory raises
    ``NotImplementedError`` (``ORBAX_REASON``), another file ``ValueError``.
    Under a model group (``layout``) the file holds the whole tensors: every
    rank reads them into the gathered state and keeps its shards (a
    collective)."""
    if os.path.isdir(path):
        raise NotImplementedError(f"weights {path!r}: {ORBAX_REASON}")
    state = gather_state_dict(model.state_dict(), layout)
    if path.endswith(".npz"):
        from ..utils.torch_weights import load_npz

        state = load_npz(path, state)
    elif path.endswith((".pkl", ".pth")):
        from ..utils.torch_weights import convert_torch_checkpoint

        state = convert_torch_checkpoint(path, state)
    elif path.endswith(".pt"):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if "model" not in ckpt:
            raise ValueError(f"weights {path!r}: not a port checkpoint (no 'model' entry)")
        unexpected = [k for k in ckpt["model"] if k not in state]
        if unexpected:
            raise KeyError(f"weights {path!r}: keys the model does not have: {unexpected[:5]}")
        missing = [k for k in state if k not in ckpt["model"]]
        if missing:
            logger.info("weights %s: %d keys keep their initialized values", path, len(missing))
        state.update(ckpt["model"])
    else:
        raise ValueError(f"unsupported weights file: {path}")
    model.load_state_dict(shard_state_dict(state, layout))
    logger.info("Loaded weights %s", path)
    return model
