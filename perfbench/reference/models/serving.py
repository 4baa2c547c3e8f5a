"""The fused open-set cascade on the device ("serving" path).

Port of ``openset_rcnn_tpu/models/serving.py``, batched over images (the JAX
version vmaps a single-image function). Fixed shapes throughout: masked
top-k and masked NMS.

  1. objectness = sqrt(iou x centerness) > thresh, top-K1;
  2. unknown split: min prototype distance > UNK_THR;
  3a. known: per-class scores > thresh, class-wise NMS, top-K;
  3b. unknown: objectness score, class-agnostic NMS, top-K, fixed id.

Every top-k keeps the JAX tie order (``ops/topk.py``). Each call runs two
greedy-NMS launches for the whole batch: class-wise over the known
candidates and class-agnostic over the stage-1 boxes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.nms import KeepFn, batched_nms_mask, nms_keep_plain, nms_mask
from ..ops.topk import stable_topk
from ..structures import RawDetections


class ServeDetections(NamedTuple):
    boxes: torch.Tensor    # (B, D, 4) in network-input coordinates
    scores: torch.Tensor   # (B, D)
    classes: torch.Tensor  # (B, D) int64 (known index or unknown id)
    valid: torch.Tensor    # (B, D) bool
    # (B,) known-branch (box, class) candidates above the score threshold that
    # did not fit the static max_known_candidates slot and were dropped
    # before NMS; nonzero means a possible divergence from the host cascade.
    known_overflow: torch.Tensor


def _topk_select(values, mask, k):
    """Top-k by value among mask; returns (values, indices, valid)."""
    v, i = stable_topk(torch.where(mask, values, torch.full_like(values, -torch.inf)), k)
    return v, i, torch.isfinite(v)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for (B, N, ...) x and (B, M) idx."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(*idx.shape, *x.shape[2:]))


def _compact(res, topk: int):
    """The first ``topk`` kept entries in score order, compacted to the front:
    (indices into the NMS input, valid)."""
    kept_rank = torch.cumsum(res.keep.long(), dim=1) - 1
    sel = res.keep & (kept_rank < topk)
    n = res.keep.shape[1]
    comp = torch.where(sel, kept_rank, n + torch.arange(n, device=sel.device))
    perm = torch.sort(comp, dim=1, stable=True).indices
    return torch.gather(res.order, 1, perm)[:, :topk], torch.gather(sel, 1, perm)[:, :topk]


def fused_cascade(
    raw: RawDetections,
    *,
    obj_thresh: float = 0.05,
    unk_thr: float = 0.23,
    known_score_thresh: float = 0.05,
    known_nms_thresh: float = 0.5,
    known_topk: int = 50,
    unknown_score_thresh: float = 0.0,
    unknown_nms_thresh: float = 0.5,
    unknown_topk: int = 50,
    unknown_id: int = 80,
    stage1_topk: int = 1000,
    max_known_candidates: int = 2000,
    keep_fn: KeepFn = nms_keep_plain,
) -> ServeDetections:
    """The open-set cascade over (B, P) raw detections; ``keep_fn`` is the
    greedy keep (the kernel wrapper by default)."""
    K = raw.known_probs.shape[-1] - 1
    # cap the static selection sizes by what actually exists
    stage1_topk = min(stage1_topk, raw.boxes.shape[1])
    max_known_candidates = min(max_known_candidates, stage1_topk * K)

    # ---- stage 1: objectness filter + top-K1 ----
    keep1 = raw.valid & (raw.objectness > obj_thresh)
    _, i1, v1 = _topk_select(raw.objectness, keep1, stage1_topk)
    boxes1 = _take(raw.boxes, i1)
    md1 = _take(raw.min_dist, i1)
    probs1 = _take(raw.known_probs, i1)[..., :K]  # drop background column
    obj1 = torch.where(v1, _take(raw.objectness, i1), torch.zeros_like(md1))
    is_unknown = md1 > unk_thr

    # ---- stage 3a: known, class-wise ----
    cand_mask = (~is_unknown[..., None]) & v1[..., None] & (probs1 > known_score_thresh)
    n_cand = cand_mask.sum(dim=(1, 2))
    known_overflow = torch.clamp(n_cand - max_known_candidates, min=0)
    B = raw.boxes.shape[0]
    known_scores = torch.where(cand_mask, probs1, torch.full_like(probs1, -torch.inf)).reshape(B, -1)
    cs, ci, cv = _topk_select(known_scores, torch.isfinite(known_scores), max_known_candidates)
    cand_box = _take(boxes1, ci // K)
    cand_cls = ci % K
    cand_score = torch.where(cv, cs, torch.zeros_like(cs))
    res = batched_nms_mask(cand_box, cand_score, cand_cls, cv, known_nms_thresh, keep_fn)
    take, kvalid = _compact(res, known_topk)
    kboxes = _take(cand_box, take)
    kscores = torch.where(kvalid, torch.gather(cand_score, 1, take), torch.zeros_like(kvalid, dtype=cs.dtype))
    kclasses = torch.gather(cand_cls, 1, take)

    # ---- stage 3b: unknown, class-agnostic ----
    umask = is_unknown & v1 & (obj1 > unknown_score_thresh)
    ures = nms_mask(boxes1, torch.where(umask, obj1, torch.zeros_like(obj1)), umask,
                    unknown_nms_thresh, keep_fn)
    utake, uvalid = _compact(ures, unknown_topk)
    uboxes = _take(boxes1, utake)
    uscores = torch.where(uvalid, torch.gather(obj1, 1, utake), torch.zeros_like(obj1[:, :1]))
    uclasses = torch.full_like(utake, unknown_id)

    return ServeDetections(
        boxes=torch.cat([uboxes, kboxes], 1),
        scores=torch.cat([uscores, kscores], 1),
        classes=torch.cat([uclasses, kclasses], 1),
        valid=torch.cat([uvalid, kvalid], 1),
        known_overflow=known_overflow,
    )
