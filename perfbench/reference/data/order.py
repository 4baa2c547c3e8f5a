"""Which records make each training batch, and each example's augmentation
draws: the order of the training loader.

Frozen copy of the batch order of ``openset_rcnn_tpu_torch/data/loader.py``
(``TrainLoader._is_landscape``, ``_block_stream``, ``_example_stream`` and
the per-example ``RandomState``), which is itself the JAX loader's, so that
the reference rebuilds a training batch from the records and the seed alone.
One process: every global batch is this process's batch.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


def is_landscape(rec: dict) -> bool:
    w, h = rec.get("width"), rec.get("height")
    if w is None or h is None:
        return True
    return w >= h


def batches(records: List[dict], batch_size: int, seed: int) -> Iterator[List[Tuple[int, int]]]:
    """Per batch, (global sequence number, record index) of its examples:
    per epoch a permutation of the records feeds two aspect-grouped queues,
    and whichever fills first is the next batch."""
    pending = {True: [], False: []}
    epoch, seq = 0, 0
    while True:
        rng = np.random.RandomState((seed, epoch))
        for i in rng.permutation(len(records)):
            q = pending[is_landscape(records[int(i)])]
            q.append(int(i))
            if len(q) == batch_size:
                yield [(seq + j, idx) for j, idx in enumerate(q)]
                seq += batch_size
                q.clear()
        epoch += 1


def example_rng(seed: int, gseq: int) -> np.random.RandomState:
    """The augmentation draws of the example with global sequence number
    ``gseq``."""
    return np.random.RandomState((seed, 7919, gseq))


def usable(records: List[dict]) -> List[dict]:
    """The records with at least one non-empty box (the loader drops the
    others when ``DATALOADER.FILTER_EMPTY_ANNOTATIONS`` is set)."""
    return [r for r in records if any(
        a["bbox"][2] > a["bbox"][0] and a["bbox"][3] > a["bbox"][1] for a in r.get("annotations", []))]
