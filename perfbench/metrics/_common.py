"""Helpers of the per-layer metric readers. A reader is
``read(run, suffix) -> float | None``: None where the run recorded nothing
to read (the harness then leaves the metric out of the line)."""
from __future__ import annotations

from typing import Optional, Sequence


def mean(values: Sequence[float]) -> Optional[float]:
    return float(sum(values) / len(values)) if values else None


def inputs(run, *keys):
    got = run.per_layer_inputs
    return None if any(got.get(k) is None for k in keys) else [got[k] for k in keys]
