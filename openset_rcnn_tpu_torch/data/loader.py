"""Input pipeline: transformed examples -> batches on the device.

Port of ``openset_rcnn_tpu/data/loader.py``: ``BatchMeta`` (``:25``),
``collate`` (``:41``), ``_filter_empty`` (``:54``), ``TrainLoader``
(``:61-199``), ``EvalLoader`` (``:202``) and ``device_prefetch`` (``:249``).
Batches stay bucket-homogeneous (landscape and portrait are grouped apart),
so the model sees at most two image shapes. Images travel as uint8, as in
the JAX loader, and are cast on the device (``OpensetRCNN.preprocess``).
``TrainLoader`` is the JAX loader line for line, so the same records and
seed give bitwise the same batches.

``device_prefetch`` is the part that differs: ``jax.device_put`` from a
thread overlaps the copy with compute by itself, while a ``.to(device)`` from
a thread runs on the default stream and waits behind the queued kernels. So
a background thread pins each batch and copies it on a stream of its own,
and the consumer's stream waits only for that batch's copy.
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..structures import GroundTruth, ImageBatch
from ..utils import tracing
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
    with tracing.span("data.collate"):
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


def _filter_empty(records: List[dict]) -> List[dict]:
    return [r for r in records if any(
        a["bbox"][2] > a["bbox"][0] and a["bbox"][3] > a["bbox"][1]
        for a in r.get("annotations", [])
    )]


class TrainLoader:
    """Infinite stream of homogeneous-bucket batches.

    Sharding is by GLOBAL-BATCH BLOCK, not by stride: every process computes
    the identical sequence of global batches (a pure function of the record
    metadata + seed) and takes its contiguous ``batch_size`` slice of each.
    Concatenating all shards therefore reproduces the single-process global
    batch exactly — training is invariant to the process layout. Aspect-ratio
    grouping likewise runs on record metadata (``width``/``height``), so all
    processes group identically without decoding a single image.
    """

    def __init__(
        self,
        records: List[dict],
        transform: DetectionTransform,
        batch_size: int,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        filter_empty: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
    ):
        if filter_empty:
            records = _filter_empty(records)
        assert records, "no usable training records"
        self.records = records
        self.transform = transform
        self.batch_size = batch_size
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def _is_landscape(self, rec: dict) -> bool:
        """Bucket from metadata: resize preserves aspect, so w >= h predicts
        the transform's landscape/portrait choice exactly (transforms.py
        bucket_for). Records without size metadata default to landscape."""
        w, h = rec.get("width"), rec.get("height")
        if w is None or h is None:
            return True
        return w >= h

    def _block_stream(self) -> Iterator[List[int]]:
        """Global batches of record indices — identical on every process.
        Per-epoch permutation feeds two aspect-grouped queues; whichever
        reaches the global batch size first emits a block."""
        gbs = self.batch_size * self.num_shards
        pending = {True: [], False: []}
        epoch = 0
        while True:
            rng = np.random.RandomState((self.seed, epoch))
            for i in rng.permutation(len(self.records)):
                q = pending[self._is_landscape(self.records[int(i)])]
                q.append(int(i))
                if len(q) == gbs:
                    yield list(q)
                    q.clear()
            epoch += 1

    def _example_stream(self) -> Iterator[Tuple[int, int]]:
        """(global_seq, record_index) for THIS shard. global_seq numbers the
        example within the global stream, so the augmentation RNG — and with
        it the produced pixels — is invariant to the shard layout."""
        bs = self.batch_size
        lo = self.shard_id * bs
        for bi, block in enumerate(self._block_stream()):
            for j, idx in enumerate(block[lo : lo + bs]):
                yield bi * bs * self.num_shards + lo + j, idx

    def _placeholder(self, rec: dict) -> TransformedExample:
        """Lockstep filler for an unreadable image: black pixels, no GT.
        Dropping the slot would desynchronise the global batch composition
        across processes."""
        bh, bw = self.transform.bucket_hw
        if not self._is_landscape(rec):
            bh, bw = bw, bh
        mg = self.transform.max_gt
        return TransformedExample(
            image=np.zeros((bh, bw, 3), np.uint8),
            image_hw=(bh, bw),
            original_hw=(bh, bw),
            bucket_hw=(bh, bw),
            boxes=np.zeros((mg, 4), np.float32),
            classes=np.zeros((mg,), np.int32),
            gt_valid=np.zeros((mg,), bool),
            image_id=rec.get("image_id"),
        )

    def __iter__(self) -> Iterator[Tuple[ImageBatch, BatchMeta]]:
        """Deterministic: batch composition and augmentations are a pure
        function of (seed, epoch) — independent of worker count AND shard
        layout. Workers transform in parallel but (a) each example's
        augmentation RNG derives from its global sequence number, and
        (b) the consumer reorders completed examples back into sequence
        order before batching, so the thread schedule cannot change the
        stream. An exception in a worker is raised here, in its sequence
        slot (JAX's loader waits for the dead worker's example forever)."""
        stream = self._example_stream()
        lock = threading.Lock()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.batch_size)
        counter = itertools.count()

        def worker():
            while True:
                with lock:
                    seq = next(counter)
                    gseq, i = next(stream)
                try:
                    rng = np.random.RandomState((self.seed, 7919, gseq))
                    ex = self.transform(self.records[i], rng)
                    if ex is None:
                        ex = self._placeholder(self.records[i])
                except Exception as e:  # handed to the consumer
                    out_q.put((seq, e))
                    return
                out_q.put((seq, ex))

        for k in range(self.num_workers):
            threading.Thread(target=worker, daemon=True, name=f"TrainLoader-{k}").start()

        # reorder buffer: release examples strictly in sequence order
        def ordered_stream():
            pending = {}
            want = 0
            while True:
                while want not in pending:
                    seq, ex = out_q.get()
                    pending[seq] = ex
                ex = pending.pop(want)
                if isinstance(ex, Exception):
                    raise ex
                yield ex
                want += 1

        # blocks are bucket-homogeneous by construction: batch every
        # consecutive batch_size examples
        buf: List[TransformedExample] = []
        for ex in ordered_stream():
            buf.append(ex)
            if len(buf) == self.batch_size:
                yield collate(buf)
                buf = []


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
            for n, (batch, meta) in enumerate(iterator):
                with tracing.span("data.h2d", batch=n):
                    if cuda:
                        with torch.cuda.stream(stream):
                            placed = _map(batch, lambda t: t.pin_memory().to(device, non_blocking=True))
                            ready = torch.cuda.Event()
                            ready.record(stream)
                        item = (placed, meta, ready)
                    else:
                        item = (_map(batch, lambda t: t.to(device)), meta, None)
                q.put(item)
        except Exception as e:  # handed to the consumer
            q.put(e)
        q.put(end)

    threading.Thread(target=worker, daemon=True, name="device_prefetch").start()
    for n in itertools.count():
        tracing.request(n)
        with tracing.span("data.wait"):
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
