"""The numbers that decide ``correct``: the program's outputs against the
reference's. A cell's file names which of them it compares, each with its
limit; the others are printed beside them.

Training (the first steps, which the window's call and feed drove):

* ``loss_gap``: the widest relative gap of a step's total loss;
  ``loss1_gap`` the first step's;
* ``grad_gap``: the widest gap between the program's and the reference's
  norm of a leaf's first-step gradient as SGD takes it (the momentum buffer
  after one step: gradient plus weight decay times the weight), over the
  larger of the reference's norm of that leaf and of the median leaf;
  ``grad_median_gap`` the median leaf's gap;
* ``update_gap``, ``update_median_gap``: the same for the norm of each
  leaf's change over the steps.

Leaves whose reference gradient is under a thousandth of the median leaf's
(nought to rounding) are left out, by that rule and not by name.

Detection (each sampled image's open-set detections in original
coordinates; "one detection" on both sides: one class, IoU at least
``MATCH_IOU``, which only the same proposal reaches, since neighbouring
anchors' boxes overlap by about 0.92):

* ``match_score_gap``: the widest score gap of one detection between the
  two sides;
* ``kept_share``: per image, the share of the reference's detections that
  the program gives too, as one detection with a score within
  ``KEPT_SCORE``, the lowest over the images (lower is worse): a detection
  missing or moved;
* ``agree_share``: per image, the share of the program's detections that
  the reference gives too, in the same sense, the lowest over the images:
  a detection added or moved;
* ``rank_gap``: per image and class, both sides' scores sorted, the shorter
  list padded with the branch's cut-off (the lower of the lowest score
  either side kept, never under the branch's threshold), the mean gap over
  the ranks; the widest over the images and classes;
* ``evaluator_gap``: the widest gap between the program's evaluator's
  metrics and the reference evaluator's over the program's own detections.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

NOUGHT = 1e-3    # a leaf whose reference gradient is under this share of the median leaf's is left out
MATCH_IOU = 0.98  # a program and a reference detection of one class this close are one detection
KEPT_SCORE = 0.05  # one detection kept by both sides scores within this (the cascade's score threshold)


def _norm_gaps(prog: Sequence[float], ref: Sequence[float], keep: np.ndarray) -> Tuple[float, int]:
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    scale = np.maximum(r, np.median(r[keep]))
    gaps = np.where(keep, np.abs(p - r) / scale, 0.0)
    i = int(np.argmax(gaps))
    return float(gaps[i]), i


def _median_gap(prog: Sequence[float], ref: Sequence[float], keep: np.ndarray) -> float:
    p, r = np.asarray(prog, np.float64)[keep], np.asarray(ref, np.float64)[keep]
    return float(np.median(np.abs(p - r) / np.maximum(r, np.median(r))))


def train_numbers(prog: Mapping[str, list], ref: Mapping[str, list]) -> Dict[str, object]:
    """``prog`` and ``ref``: ``losses`` (per step, a dict with
    ``total_loss``), and per trainable leaf in ``names`` order
    ``first_grad_norms`` and ``change_norms``."""
    def losses(side, keys):
        return np.asarray([sum(step[k] for k in keys) for step in side["losses"]], np.float64)

    lp, lr = losses(prog, ("total_loss",)), losses(ref, ("total_loss",))
    g_ref = np.asarray(ref["first_grad_norms"], np.float64)
    keep = g_ref >= NOUGHT * np.median(g_ref)
    grad_gap, gi = _norm_gaps(prog["first_grad_norms"], g_ref, keep)
    update_gap, ui = _norm_gaps(prog["change_norms"], ref["change_norms"], keep)
    names = ref["names"]
    return {"loss_gap": float(np.max(np.abs(lp - lr) / np.abs(lr))), "loss1_gap": float(abs(lp[0] - lr[0]) / abs(lr[0])),
            "grad_gap": grad_gap, "grad_median_gap": _median_gap(prog["first_grad_norms"], g_ref, keep),
            "update_gap": update_gap, "update_median_gap": _median_gap(prog["change_norms"], ref["change_norms"], keep),
            "worst_grad_leaf": names[gi], "worst_update_leaf": names[ui],
            "leaves_left_out": [n for n, k in zip(names, keep) if not k]}


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return float(inter / union) if union > 0 else 0.0


def _pairs(pb: np.ndarray, rb: np.ndarray) -> List[Tuple[int, int, float]]:
    """(i, j, IoU) of program box i and its closest reference box j of one
    class, where that IoU is at least ``MATCH_IOU``."""
    out = []
    for i, a in enumerate(pb):
        ious = [_iou(a, b) for b in rb]
        if ious:
            j = int(np.argmax(ious))
            if ious[j] >= MATCH_IOU:
                out.append((i, j, ious[j]))
    return out


def detection_numbers(prog: Mapping[str, np.ndarray], ref: Mapping[str, np.ndarray], unknown_id: int,
                      known_thresh: float, unknown_thresh: float) -> Dict[str, float]:
    """One image's numbers. ``prog``/``ref``: ``boxes`` (N, 4), ``scores``,
    ``classes``. Besides the gaps and shares: the counts ``pairs``,
    ``kept`` (reference detections kept), ``agreed`` (program detections
    the reference gives too), ``ref_dets`` and ``prog_dets``."""
    out = {"match_score_gap": 0.0, "rank_gap": 0.0, "pairs": 0, "kept": 0, "agreed": 0, "ref_dets": 0,
           "prog_dets": 0}
    cut = {}
    for branch, thresh in (("known", known_thresh), ("unknown", unknown_thresh)):
        lows = []
        for side in (prog, ref):
            s = np.asarray(side["scores"], np.float64)[(np.asarray(side["classes"]) == unknown_id) == (branch == "unknown")]
            if len(s):
                lows.append(float(s.min()))
        cut[branch] = max(thresh, min(lows)) if lows else thresh
    classes = set(np.asarray(prog["classes"]).tolist()) | set(np.asarray(ref["classes"]).tolist())
    for c in classes:
        pad = cut["unknown" if c == unknown_id else "known"]
        sides = []
        for side in (prog, ref):
            m = np.asarray(side["classes"]) == c
            sides.append((np.asarray(side["scores"], np.float64)[m], np.asarray(side["boxes"], np.float64)[m]))
        lists = [np.sort(s)[::-1] for s, _ in sides]
        n = max(len(lists[0]), len(lists[1]))
        if n:
            a, b = (np.concatenate([x, np.full(n - len(x), pad)]) for x in lists)
            out["rank_gap"] = max(out["rank_gap"], float(np.mean(np.abs(a - b))))
        pairs = _pairs(sides[0][1], sides[1][1])
        kept = set()
        for i, j, _ in pairs:
            gap = float(abs(sides[0][0][i] - sides[1][0][j]))
            out["match_score_gap"] = max(out["match_score_gap"], gap)
            if gap <= KEPT_SCORE:
                out["agreed"] += 1
                kept.add(j)
        out["kept"] += len(kept)
        out["pairs"] += len(pairs)
        out["ref_dets"] += len(sides[1][0])
        out["prog_dets"] += len(sides[0][0])
    out["kept_share"] = out["kept"] / out["ref_dets"] if out["ref_dets"] else 1.0
    out["agree_share"] = out["agreed"] / out["prog_dets"] if out["prog_dets"] else 1.0
    return out


def widest(per_image: List[Dict[str, float]]) -> Dict[str, float]:
    """The widest of each gap over the images, the lowest of each share, and
    the counts summed."""
    if not per_image:
        return {}
    out = {k: max(d[k] for d in per_image) for k in ("match_score_gap", "rank_gap")}
    for k in ("kept_share", "agree_share"):
        out[k] = min(d[k] for d in per_image)
    for k in ("pairs", "kept", "agreed", "ref_dets", "prog_dets"):
        out[k] = sum(d[k] for d in per_image)
    return out


def evaluator_gap(prog: Mapping[str, float], ref: Mapping[str, float]) -> float:
    if set(prog) != set(ref):
        return float("inf")
    return max(abs(float(prog[k]) - float(ref[k])) for k in ref)
