"""Evaluation input pipeline: transformed examples -> batches on the device.

Port of the eval half of ``openset_rcnn_tpu/data/loader.py``: ``BatchMeta``
(``:25``), ``collate`` (``:41``), ``EvalLoader`` (``:202``) and
``device_prefetch`` (``:249``). Batches stay bucket-homogeneous (landscape and
portrait are grouped apart), so the model sees at most two image shapes.
Images travel as uint8, as in the JAX loader, and are cast on the device
(``OpensetRCNN.preprocess``). The training loader comes with the data slice
of the training loop.

``device_prefetch`` is the part that differs: ``jax.device_put`` from a
thread overlaps the copy with compute by itself, while a ``.to(device)`` from
a thread runs on the default stream and waits behind the queued kernels. So
a background thread pins each batch and copies it on a stream of its own,
and the consumer's stream waits only for that batch's copy.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..structures import GroundTruth, ImageBatch
from .transforms import DetectionTransform, TransformedExample


class BatchMeta:
    """Host-side metadata travelling alongside an ImageBatch.

    ``n_real``: number of genuine examples — a final partial eval batch is
    padded up to the static batch size by repeating its last example, and
    the metadata lists are truncated so consumers iterate real images only.
    """

    def __init__(self, examples: List[TransformedExample], n_real: Optional[int] = None):
        n = len(examples) if n_real is None else n_real
        self.image_ids = [e.image_id for e in examples[:n]]
        self.input_hw = [e.image_hw for e in examples[:n]]
        self.original_hw = [e.original_hw for e in examples[:n]]
        self.bucket_hw = examples[0].bucket_hw


def collate(examples: List[TransformedExample], n_real: Optional[int] = None) -> Tuple[ImageBatch, BatchMeta]:
    """Host tensors: (B, H, W, 3) uint8 images, (B, 2) float32 sizes, padded GT."""
    gt = GroundTruth(
        boxes=torch.from_numpy(np.stack([e.boxes for e in examples])),
        classes=torch.from_numpy(np.stack([e.classes for e in examples])),
        valid=torch.from_numpy(np.stack([e.gt_valid for e in examples])),
    )
    batch = ImageBatch(
        images=torch.from_numpy(np.stack([e.image for e in examples])),
        image_hw=torch.tensor([e.image_hw for e in examples], dtype=torch.float32),
        gt=gt,
    )
    return batch, BatchMeta(examples, n_real)


class EvalLoader:
    """Sequential loader with per-bucket batch accumulation.

    Batches stay bucket-homogeneous by accumulating landscape/portrait groups
    independently; final partial groups are padded to the static batch size
    (BatchMeta.n_real masks the pads) so the model sees ONE shape per bucket.
    """

    def __init__(self, records: List[dict], transform: DetectionTransform, batch_size: int = 1,
                 pad_final: bool = True):
        self.records = records
        self.transform = transform
        self.batch_size = batch_size
        self.pad_final = pad_final

    def __len__(self):
        return len(self.records)

    def __iter__(self) -> Iterator[Tuple[ImageBatch, BatchMeta]]:
        rng = np.random.RandomState(0)  # test transform is deterministic
        groups = {}
        for rec in self.records:
            ex = self.transform(rec, rng)
            if ex is None:
                continue
            groups.setdefault(ex.bucket_hw, []).append(ex)
            g = groups[ex.bucket_hw]
            if len(g) == self.batch_size:
                yield collate(g)
                groups[ex.bucket_hw] = []
        for g in groups.values():
            if not g:
                continue
            n_real = len(g)
            if self.pad_final and n_real < self.batch_size:
                g = g + [g[-1]] * (self.batch_size - n_real)
            yield collate(g, n_real)


def _map(batch: ImageBatch, fn) -> ImageBatch:
    gt = None if batch.gt is None else GroundTruth(fn(batch.gt.boxes), fn(batch.gt.classes), fn(batch.gt.valid))
    return ImageBatch(fn(batch.images), fn(batch.image_hw), gt)


def device_prefetch(iterator, device: Union[str, torch.device], depth: int = 2):
    """Yield ``(batch on device, meta)`` for each ``(host batch, meta)`` of
    ``iterator``, staging up to ``depth`` batches ahead from a background
    thread (which also runs the iterator's decoding and transforms).

    On a GPU the thread copies each batch from pinned memory on a copy stream
    and records an event; the batch is yielded once the consumer's current
    stream waits on that event, so the copy overlaps the previous batch's
    kernels and no host thread blocks on it. Each tensor is marked as used by
    the consumer's stream, so its memory is not reused before that stream's
    work on it is done. An exception in the thread is raised here.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            if cuda:
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)
            for batch, meta in iterator:
                if cuda:
                    with torch.cuda.stream(stream):
                        placed = _map(batch, lambda t: t.pin_memory().to(device, non_blocking=True))
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    q.put((placed, meta, ready))
                else:
                    q.put((_map(batch, lambda t: t.to(device)), meta, None))
        except Exception as e:  # handed to the consumer
            q.put(e)
        q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, Exception):
            raise item
        placed, meta, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            _map(placed, lambda t: t.record_stream(consumer))
        yield placed, meta
