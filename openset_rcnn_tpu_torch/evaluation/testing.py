"""Inference harness: drive eval over a dataset and score it.

Port of ``openset_rcnn_tpu/evaluation/testing.py:198-316``
(``proposal_ar_on_dataset``, ``inference_on_dataset``): the device forward
per batch (``Predictor``, ``ProposalPredictor``), the host cascade or the
host finalize of the fused one, and the evaluator.

The JAX loop overlaps batch i's host work with batch i+1's device work for
free: dispatch is asynchronous and pulling batch i waits only for batch i.
In PyTorch a plain ``.cpu()`` of batch i, issued after batch i+1's launches,
waits for batch i+1 too. So each batch's outputs are copied to pinned host
memory right after its own launches (``to_host``), with an event recorded
behind the copies, and the host waits only on that event.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..data.loader import device_prefetch
from ..utils import tracing
from .postprocess import finalize_serve_image, postprocess_image

logger = logging.getLogger(__name__)


class HostCopy(NamedTuple):
    """Host copies of a NamedTuple or dataclass of device tensors, and the
    event behind them (None on the CPU)."""

    fields: Dict[str, torch.Tensor]
    ready: Optional[torch.cuda.Event]

    def numpy(self, wait: Optional[tracing.Span] = None) -> Dict[str, np.ndarray]:
        """The copies as numpy arrays, once they have landed. ``wait`` is
        the span around the wait, for a caller that keeps its time
        (``tracing.clock("eval.wait")``); ``tracing.span("eval.wait")``
        when None."""
        with tracing.span("eval.wait") if wait is None else wait:
            if self.ready is not None:
                self.ready.synchronize()
            return {k: v.numpy() for k, v in self.fields.items()}


def to_host(out, names) -> HostCopy:
    """Enqueue non-blocking copies of ``out``'s fields ``names`` into pinned
    host memory on the current stream, then record an event behind them."""
    tensors = {k: getattr(out, k) for k in names}
    if not any(t.is_cuda for t in tensors.values()):
        return HostCopy({k: t.detach() for k, t in tensors.items()}, None)
    host = {}
    for k, t in tensors.items():
        host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host[k].copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return HostCopy(host, ready)


def proposal_ar_on_dataset(infer, loader, records, limits=(100, 1000)) -> Dict[str, float]:
    """Collect proposals per image, gather across processes, score AR
    against ALL GT boxes (known + unknown pooled — the reference relabels
    then pools, os_coco_evaluation.py:465-573). ``infer``: a
    ``ProposalPredictor``."""
    from ..parallel import gather_object, num_processes
    from .proposals import evaluate_box_proposals

    entries = []
    for batch, meta in device_prefetch(loader, infer.device):
        out = to_host(infer(batch.images, batch.image_hw), ("boxes", "scores", "valid")).numpy()
        for i, image_id in enumerate(meta.image_ids):
            v = out["valid"][i]
            b = out["boxes"][i][v]
            s = out["scores"][i][v]
            ih, iw = meta.input_hw[i]
            oh, ow = meta.original_hw[i]
            b = b * np.asarray([ow / iw, oh / ih, ow / iw, oh / ih], b.dtype)
            entries.append({"image_id": image_id, "boxes": b, "scores": s})
    if num_processes() > 1:
        merged = []
        for part in gather_object(entries):
            merged.extend(part)
        entries = merged

    gt_map = {
        r["image_id"]: np.asarray([a["bbox"] for a in r.get("annotations", [])], np.float64).reshape(-1, 4)
        for r in records
    }
    res = evaluate_box_proposals(entries, gt_map, limits=limits)
    logger.info("proposal AR: %s", {k: round(v, 4) for k, v in res.items()})
    return res


SERVE_FIELDS = ("boxes", "scores", "classes", "valid", "known_overflow")
RAW_FIELDS = ("boxes", "objectness", "min_dist", "pln_class", "known_probs", "valid")


def inference_on_dataset(predictor, loader, evaluator, fused: bool = True,
                         timings: Optional[Dict[str, List[float]]] = None) -> Dict[str, float]:
    """Run ``predictor`` (a ``Predictor``) over ``loader``'s batches and feed
    each image's detections to ``evaluator``; returns its metrics.

    ``fused``: the cascade runs on the device and the host only rescales
    (``finalize_serve_image``); else the raw outputs go through the exact
    host cascade (``postprocess_image``), the parity oracle.

    One-batch pipelining: batch i+1 is launched before batch i's results are
    read on the host, and batch i's copies were enqueued right after its own
    launches, so the host waits for batch i only. ``timings``, when given,
    receives per batch the host ms spent waiting for the copies
    (``wait_ms``) and in the cascade or finalize plus the evaluator
    (``consume_ms``), and the loop's ``seconds`` and ``images``: the
    lengths of its ``eval.wait`` and ``eval.consume`` spans, from their
    own clock reads (``utils/tracing.py``).
    """
    post_cfg = predictor.post_cfg
    evaluator.reset()
    n_images = 0
    n_overflow_images = 0
    max_overflow = 0
    if timings is not None:
        timings.update(wait_ms=[], consume_ms=[])
    t0 = time.perf_counter()

    def consume(host, meta, index):
        nonlocal n_images, n_overflow_images, max_overflow
        tracing.request(index)
        wait = tracing.clock("eval.wait")
        out = host.numpy(wait)
        with tracing.clock("eval.consume", image_ids=meta.image_ids) as span:
            if fused:
                # the loader pads the final partial batch by repeating its last
                # example and truncates meta.image_ids to the real count — only
                # count overflow on slots that are actually evaluated
                ov = out["known_overflow"][: len(meta.image_ids)]
                if (ov > 0).any():
                    n_overflow_images += int((ov > 0).sum())
                    max_overflow = max(max_overflow, int(ov.max()))
            for i, image_id in enumerate(meta.image_ids):
                if fused:
                    dets = finalize_serve_image(out["boxes"][i], out["scores"][i], out["classes"][i], out["valid"][i],
                                                meta.input_hw[i], meta.original_hw[i], post_cfg)
                else:
                    dets = postprocess_image(out["boxes"][i], out["objectness"][i], out["min_dist"][i],
                                             out["pln_class"][i], out["known_probs"][i], out["valid"][i],
                                             meta.input_hw[i], meta.original_hw[i], post_cfg)
                evaluator.process(image_id, dets.boxes, dets.scores, dets.classes)
                n_images += 1
        if timings is not None:
            timings["wait_ms"].append(wait.ms)
            timings["consume_ms"].append(span.ms)

    pending = None
    for index, (batch, meta) in enumerate(device_prefetch(loader, predictor.device)):
        if fused:
            host = to_host(predictor(batch.images, batch.image_hw), SERVE_FIELDS)
        else:
            host = to_host(predictor.raw(batch.images, batch.image_hw), RAW_FIELDS)
        if pending is not None:
            consume(*pending)
        pending = (host, meta, index)
    if pending is not None:
        consume(*pending)
    dt = time.perf_counter() - t0
    if timings is not None:
        timings.update(seconds=dt, images=n_images)
    if n_images:
        logger.info("inference done: %d images in %.1fs (%.2f img/s)", n_images, dt, n_images / dt)
    if n_overflow_images:
        # the fused cascade's static candidate slot truncated (box, class)
        # pairs the reference would have kept (softmax_classifier.py:47-104)
        # -> metrics may diverge from the host cascade on these images
        logger.warning(
            "fused cascade known-candidate overflow on %d/%d images "
            "(max %d pairs dropped before known NMS); re-run with "
            "TPU.EVAL_FUSED=False or raise TEST.DETECTIONS_PER_IMAGE "
            "for exact parity",
            n_overflow_images, n_images, max_overflow,
        )
    with tracing.span("eval.evaluate"):
        return evaluator.evaluate()
