"""Checkpoint save/resume with ``torch.save``.

Port of ``openset_rcnn_tpu/engine/checkpoint.py`` (Orbax there): saves
``{"model": state_dict, "optimizer": optimizer state_dict, "step": n}`` as
``model_{step:07d}.pt`` every CHECKPOINT_PERIOD, keeps a ``last_checkpoint``
marker, and supports
  * --resume: continue from the latest checkpoint (restores the step, the
    parameters, the buffers and the SGD momentum);
  * weights-only load (``MODEL.WEIGHTS``): a port checkpoint's model weights.

The JAX package's other weight formats (Orbax directories, converted
``.npz``, d2 ``.pkl``/``.pth``) come with the weight converters (ROADMAP.md
queue A item 6) and raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch
from torch import nn

logger = logging.getLogger(__name__)

UNPORTED_FORMATS = (".npz", ".pkl", ".pth")


class Checkpointer:
    """Saves and restores a ``train_state.TrainState`` (step, model,
    optimizer) under ``output_dir``."""

    def __init__(self, output_dir: str):
        self.dir = os.path.abspath(output_dir)
        os.makedirs(self.dir, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, state, step: int) -> str:
        from ..parallel import is_main_process

        path = os.path.join(self.dir, f"model_{step:07d}.pt")
        if is_main_process():
            tmp = path + ".tmp"
            torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                        "step": int(step)}, tmp)
            os.replace(tmp, path)
            with open(os.path.join(self.dir, "last_checkpoint"), "w") as f:
                f.write(os.path.basename(path))
            logger.info("Saved checkpoint %s", path)
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
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        logger.info("Restored checkpoint %s (step=%d)", path, state.step)
        return state

    def resume_or_load(self, state, weights: str = "", resume: bool = False) -> Tuple[object, bool]:
        """d2-style policy: --resume continues from the latest checkpoint;
        otherwise load weights-only from ``weights`` if given."""
        if resume and self.latest_path():
            return self.restore(state), True
        if weights:
            load_weights_file(weights, state.model)
        return state, False


def load_weights_file(path: str, model: nn.Module) -> nn.Module:
    """Load model weights into ``model`` from a port checkpoint (``.pt``,
    its ``model`` entry). Missing keys keep their initialized values;
    unknown keys and shape mismatches raise. The JAX package's other formats
    raise ``NotImplementedError``."""
    if os.path.isdir(path) or path.endswith(UNPORTED_FORMATS):
        raise NotImplementedError(
            f"weights {path!r}: Orbax directories, .npz, .pkl and .pth weights are not ported yet; they come "
            "with the weight converters (ROADMAP.md queue A item 6). A port checkpoint (.pt) loads.")
    if not path.endswith(".pt"):
        raise ValueError(f"unsupported weights file: {path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model" not in ckpt:
        raise ValueError(f"weights {path!r}: not a port checkpoint (no 'model' entry)")
    missing, unexpected = model.load_state_dict(ckpt["model"], strict=False)
    if unexpected:
        raise KeyError(f"weights {path!r}: keys the model does not have: {unexpected[:5]}")
    if missing:
        logger.info("weights %s: %d keys keep their initialized values", path, len(missing))
    logger.info("Loaded weights %s", path)
    return model
