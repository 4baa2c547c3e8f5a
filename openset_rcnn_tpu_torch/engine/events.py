"""Metrics/event writing.

Port of ``openset_rcnn_tpu/engine/events.py``, the host-side equivalent of
d2's EventStorage + writers: scalars are written per call, flushed every
``flush_period`` steps to the console, ``metrics.json`` (one JSON object per
line, the JAX package's format) and TensorBoard through tensorboardX when it
is importable (the port does not require it).
"""
from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Dict, Optional

logger = logging.getLogger(__name__)


def _summary_writer(log_dir: str):
    """tensorboardX's SummaryWriter, or None when it is not importable."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class EventWriter:
    """Writes on the main process only (reference parity: d2 writers exist
    on rank 0, train.py:125,159-163); on other processes every method is a
    no-op so the engine code needs no rank guards."""

    def __init__(self, output_dir: str, flush_period: int = 20, use_tensorboard: bool = True):
        from ..parallel import is_main_process

        self._active = is_main_process()
        if not self._active:
            return
        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        self.flush_period = flush_period
        self._json_path = os.path.join(output_dir, "metrics.json")
        self._json_file = open(self._json_path, "a")
        self._tb = _summary_writer(os.path.join(output_dir, "tb")) if use_tensorboard else None
        self._last_time: Optional[float] = None
        self._step_times: deque = deque(maxlen=flush_period)

    def write(self, step: int, scalars: Dict[str, float]):
        if not self._active:
            return
        now = time.perf_counter()
        if self._last_time is not None:
            self._step_times.append(now - self._last_time)
        self._last_time = now

        record = {"iteration": step}
        record.update({k: float(v) for k, v in scalars.items()})
        if self._step_times:
            record["time"] = sum(self._step_times) / len(self._step_times)
        self._json_file.write(json.dumps(record) + "\n")

        if self._tb is not None:
            for k, v in record.items():
                if k != "iteration":
                    self._tb.add_scalar(k, v, step)

        if step % self.flush_period == 0:
            self._json_file.flush()
            msg = "  ".join(f"{k}: {v:.4g}" for k, v in record.items() if k != "iteration")
            logger.info("iter %d  %s", step, msg)

    def close(self):
        if not self._active:
            return
        self._json_file.close()
        if self._tb is not None:
            self._tb.close()
