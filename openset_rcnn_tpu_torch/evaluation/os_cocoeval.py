"""Open-set COCO-style evaluation core (numpy, no pycocotools).

Copy of ``openset_rcnn_tpu/evaluation/os_cocoeval.py``, kept in the port so
that it imports nothing of the JAX package.

From-scratch rebuild of the reference's forked COCOeval
(evaluation/os_cocoeval.py:10-972) with identical metric semantics:

  * GT and detections are partitioned into known (per category) and unknown
    (category id ``unknown_id``); five cross matchings are computed per
    image: known-dt x {its-category GT, other-known GT, unknown GT} and
    unknown-dt x {known GT (all categories pooled), unknown GT} (ref :85-95);
  * matching is the COCO greedy algorithm per IoU threshold (score-sorted
    detections, each grabs the best not-yet-matched GT; ignored GT sorts
    last and an already-made real match never upgrades to an ignored GT);
  * accumulation produces the COCO (T, R, K, A, M) precision tensor for
    known classes plus open-set counters: ``unk_det_as_known`` (-> AOSE),
    ``fp_os``/``tp_plus_fp_cs`` at the 101 recall points (-> WI at recall
    0.8), ``ok_det_as_known``, and the unknown-class (T, R, A, M) tensor
    plus ``k_det_as_unk`` (ref :557-785);
  * the 30-slot stats vector layout matches ref :933-966.

The per-image greedy matcher dispatches to the C++ ``evalcore`` extension
when built (native/evalcore.cpp) and falls back to numpy otherwise.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# COCO defaults
IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
AREA_LBLS = ("all", "small", "medium", "large")


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """COCO bbox IoU: boxes are [x, y, w, h]; for crowd GT the union is the
    detection's own area (maskUtils.iou semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.maximum(
        np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :]), 0
    )
    ih = np.maximum(
        np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :]), 0
    )
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :].astype(bool), d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


_GREEDY_NATIVE_WARNED = False


def greedy_match(
    ious: np.ndarray,       # (D, G) detections already score-sorted
    gt_ignore: np.ndarray,  # (G,) 0/1, already sorted ignore-last
    iscrowd: np.ndarray,    # (G,)
    iou_thrs: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """COCO greedy matching for all thresholds.

    Returns (dt_matched (T, D) bool, dt_match_ignore (T, D) bool): whether
    each detection matched a GT and whether that GT was an ignore GT.
    """
    try:
        from .evalcore_binding import greedy_match_native

        return greedy_match_native(ious, gt_ignore, iscrowd, iou_thrs)
    except (ImportError, OSError, RuntimeError):
        # expected: extension not built / toolchain absent -> numpy fallback
        pass
    except Exception:
        # unexpected (layout/binding bug): still fall back, but say so once
        # instead of silently degrading every eval to the slower path
        global _GREEDY_NATIVE_WARNED
        if not _GREEDY_NATIVE_WARNED:
            _GREEDY_NATIVE_WARNED = True
            import logging, traceback

            logging.getLogger(__name__).warning(
                "native greedy_match failed unexpectedly; using numpy "
                "fallback:\n%s", traceback.format_exc()
            )
    D, G = ious.shape
    T = len(iou_thrs)
    dtm = np.zeros((T, D), bool)
    dt_ig = np.zeros((T, D), bool)
    for ti, t in enumerate(iou_thrs):
        gt_taken = np.zeros(G, bool)
        for d in range(D):
            best = min(t, 1 - 1e-10)
            m = -1
            for g in range(G):
                if gt_taken[g] and not iscrowd[g]:
                    continue
                if m > -1 and gt_ignore[m] == 0 and gt_ignore[g] == 1:
                    break
                if ious[d, g] < best:
                    continue
                best = ious[d, g]
                m = g
            if m == -1:
                continue
            dtm[ti, d] = True
            dt_ig[ti, d] = bool(gt_ignore[m])
            gt_taken[m] = True
    return dtm, dt_ig


@dataclass
class _ImgEval:
    """Per-(image, category, area) matching products for one dt set."""

    scores: np.ndarray        # (D,) sorted desc
    matched: np.ndarray       # (T, D)
    ignore: np.ndarray        # (T, D) final dt ignore flags
    n_gt: int                 # non-ignored GT count


def _prep_group(dts, max_det):
    """Sort by -score (stable) and truncate."""
    order = np.argsort([-d["score"] for d in dts], kind="mergesort")[:max_det]
    return [dts[i] for i in order]


def _gt_arrays(gts, a_lo, a_hi):
    boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
    crowd = np.asarray([int(g.get("iscrowd", 0)) for g in gts])
    area = np.asarray([g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts])
    ignore = (crowd > 0) | (area < a_lo) | (area > a_hi)
    order = np.argsort(ignore, kind="mergesort")
    return boxes[order], crowd[order], ignore[order].astype(int), order


def _precompute_group(dts, gts):
    """Area-independent products for one (dt-list, gt-list): arrays + the
    IoU matrix in ORIGINAL gt order (reused across all 4 area ranges)."""
    d_boxes = np.asarray([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
    scores = np.asarray([d["score"] for d in dts])
    g_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
    g_crowd = np.asarray([int(g.get("iscrowd", 0)) for g in gts])
    g_area = np.asarray([g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts])
    ious = bbox_iou_xywh(d_boxes, g_boxes, g_crowd) if len(gts) and len(dts) else None
    d_area = d_boxes[:, 2] * d_boxes[:, 3]
    return dict(scores=scores, d_area=d_area, g_crowd=g_crowd, g_area=g_area, ious=ious, n_gt=len(gts))


def _match_group_pre(pre, a_lo, a_hi, iou_thrs):
    """Per-area matching over precomputed group products."""
    D = len(pre["scores"])
    T = len(iou_thrs)
    g_crowd_o = pre["g_crowd"]
    g_area = pre["g_area"]
    ignore_o = (g_crowd_o > 0) | (g_area < a_lo) | (g_area > a_hi)
    order = np.argsort(ignore_o, kind="mergesort")
    g_ig = ignore_o[order].astype(int)
    g_crowd = g_crowd_o[order]
    scores = pre["scores"]
    d_area = pre["d_area"]

    if pre["n_gt"] == 0 or D == 0:
        matched = np.zeros((T, D), bool)
        m_ig = np.zeros((T, D), bool)
    else:
        ious = pre["ious"][:, order]
        matched, m_ig = greedy_match(ious, g_ig, g_crowd, iou_thrs)

    out_of_area = (d_area < a_lo) | (d_area > a_hi)
    dt_ignore = m_ig | (~matched & out_of_area[None, :])
    n_gt = int(np.sum(g_ig == 0))
    return _ImgEval(scores=scores, matched=matched, ignore=dt_ignore, n_gt=n_gt)


_AREA_RANGES_ARR = np.asarray([AREA_RNGS[l] for l in AREA_LBLS])
_NATIVE_WARNED = False


def _match_groups_all_areas(pres, iou_thrs, area_ranges=_AREA_RANGES_ARR):
    """Match a list of precomputed groups for EVERY area range at once.

    Dispatches the whole (group x area x threshold) loop to the C++
    ``match_category`` kernel in one ctypes call (the per-group dispatch
    overhead dominated host eval time); numpy fallback loops the per-group
    matcher. Returns (matched (A, T, sumD), ignore (A, T, sumD),
    n_gt (A, n_groups)) where group i's detections occupy columns
    [sum(D[:i]), sum(D[:i+1])).
    """
    A = len(area_ranges)
    T = len(iou_thrs)
    D = np.asarray([len(p["scores"]) for p in pres], np.int64)
    G = np.asarray([p["n_gt"] for p in pres], np.int64)
    sum_d = int(D.sum())
    try:
        from .evalcore_binding import match_category_native

        ious_flat = (
            np.concatenate([p["ious"].ravel() for p in pres if p["ious"] is not None])
            if any(p["ious"] is not None for p in pres)
            else np.zeros((0,), np.float64)
        )
        d_area = (
            np.concatenate([p["d_area"] for p in pres]) if pres else np.zeros((0,))
        )
        g_area = (
            np.concatenate([p["g_area"] for p in pres]) if pres else np.zeros((0,))
        )
        g_crowd = (
            np.concatenate([p["g_crowd"] for p in pres]) if pres else np.zeros((0,))
        )
        return match_category_native(
            ious_flat, d_area, g_area, g_crowd, D, G, area_ranges, iou_thrs
        )
    except (ImportError, OSError, RuntimeError):
        # expected: extension not built / toolchain absent -> numpy fallback
        pass
    except Exception:
        # unexpected (layout/binding bug): still fall back, but say so once
        # instead of silently degrading every eval to the slower path
        global _NATIVE_WARNED
        if not _NATIVE_WARNED:
            _NATIVE_WARNED = True
            import logging, traceback

            logging.getLogger(__name__).warning(
                "native match_category failed unexpectedly; using numpy "
                "fallback:\n%s", traceback.format_exc()
            )
    matched = np.zeros((A, T, sum_d), bool)
    ignore = np.zeros((A, T, sum_d), bool)
    n_gt = np.zeros((A, len(pres)), np.int32)
    doff = np.concatenate([[0], np.cumsum(D)])
    for ai, (a_lo, a_hi) in enumerate(area_ranges):
        for i, p in enumerate(pres):
            ev = _match_group_pre(p, a_lo, a_hi, iou_thrs)
            matched[ai, :, doff[i] : doff[i + 1]] = ev.matched
            ignore[ai, :, doff[i] : doff[i + 1]] = ev.ignore
            n_gt[ai, i] = ev.n_gt
    return matched, ignore, n_gt


def _match_group(dts, gts, a_lo, a_hi, iou_thrs, ious_presorted=None):
    """Full per-image matching for one (dt-list, gt-list, area range)."""
    D = len(dts)
    T = len(iou_thrs)
    g_boxes, g_crowd, g_ig, g_order = _gt_arrays(gts, a_lo, a_hi)
    d_boxes = np.asarray([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
    d_area = d_boxes[:, 2] * d_boxes[:, 3]
    scores = np.asarray([d["score"] for d in dts])

    if len(gts) == 0:
        matched = np.zeros((T, D), bool)
        m_ig = np.zeros((T, D), bool)
    else:
        ious = bbox_iou_xywh(d_boxes, g_boxes, g_crowd)
        matched, m_ig = greedy_match(ious, g_ig, g_crowd, iou_thrs)

    # unmatched detections outside the area range are ignored
    out_of_area = (d_area < a_lo) | (d_area > a_hi)
    dt_ignore = m_ig | (~matched & out_of_area[None, :])
    n_gt = int(np.sum(g_ig == 0))
    return _ImgEval(scores=scores, matched=matched, ignore=dt_ignore, n_gt=n_gt)


@dataclass
class OpenSetCocoEval:
    """Evaluate known + unknown detections against open-set GT.

    Args:
        gt_anns: COCO-style GT annotation dicts (already relabeled: any
            category not in known_cat_ids must carry category_id ==
            unknown_id — the wrapper does this, mirroring
            os_coco_evaluation.py:603-605).
        dt_anns: detection dicts {image_id, category_id, bbox(xywh), score}.
    """

    gt_anns: List[dict]
    dt_anns: List[dict]
    image_ids: List
    known_cat_ids: Sequence[int]
    unknown_id: int = 1000
    max_dets: Sequence[int] = (10, 20, 30, 50, 100)
    iou_thrs: np.ndarray = field(default_factory=lambda: IOU_THRS.copy())
    rec_thrs: np.ndarray = field(default_factory=lambda: REC_THRS.copy())

    def run(self) -> Dict[str, np.ndarray]:
        kcats = sorted(set(self.known_cat_ids))
        max_det = max(self.max_dets)
        T, R = len(self.iou_thrs), len(self.rec_thrs)
        K, A, M = len(kcats), len(AREA_LBLS), len(self.max_dets)

        # ---- partition ----
        k_gts = defaultdict(list)   # (img, cat) -> gts
        unk_gts = defaultdict(list)
        for g in self.gt_anns:
            if g["category_id"] == self.unknown_id:
                unk_gts[g["image_id"]].append(g)
            else:
                k_gts[(g["image_id"], g["category_id"])].append(g)
        ok_gts = defaultdict(list)  # (img, cat) -> known gts of OTHER cats
        for (img, cat), gts in list(k_gts.items()):
            for other in kcats:
                if other != cat:
                    ok_gts[(img, other)].extend(gts)

        k_dts = defaultdict(list)
        unk_dts = defaultdict(list)
        for d in self.dt_anns:
            if d["category_id"] == self.unknown_id:
                unk_dts[d["image_id"]].append(d)
            else:
                k_dts[(d["image_id"], d["category_id"])].append(d)

        # ---- per-image matching (known dts) ----
        # kd[(cat, area_idx)][img] = dict of _ImgEval vs kgt / okgt / unkgt
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        unk_det_as_known = np.zeros((T, K, A, M))
        ok_det_as_known = np.zeros((T, K, A, M))
        fp_os = np.zeros((T, R, K, A, M))
        tp_plus_fp_cs = np.zeros((T, R, K, A, M))

        for ki, cat in enumerate(kcats):
            # Pre-sort dts once per (img, cat) with the LARGEST maxDet.
            per_img = {}
            for img in self.image_ids:
                dts = _prep_group(k_dts.get((img, cat), []), max_det)
                gts_k = k_gts.get((img, cat), [])
                gts_ok = ok_gts.get((img, cat), [])
                gts_u = unk_gts.get(img, [])
                if not dts and not gts_k:
                    per_img[img] = None
                    continue
                per_img[img] = (dts, gts_k, gts_ok, gts_u)

            pres_k, pres_ok, pres_u = [], [], []
            for img in self.image_ids:
                grp = per_img[img]
                if grp is None:
                    continue
                dts, gts_k, gts_ok, gts_u = grp
                pres_k.append(_precompute_group(dts, gts_k))
                pres_ok.append(_precompute_group(dts, gts_ok))
                pres_u.append(_precompute_group(dts, gts_u))
            if not pres_k:
                continue
            scores_flat = np.concatenate([p["scores"] for p in pres_k])
            pos_in_img = np.concatenate(
                [np.arange(len(p["scores"])) for p in pres_k]
            )
            M_k, IG_k, ngt_k = _match_groups_all_areas(pres_k, self.iou_thrs)
            M_ok, IG_ok, _ = _match_groups_all_areas(pres_ok, self.iou_thrs)
            M_u, IG_u, _ = _match_groups_all_areas(pres_u, self.iou_thrs)
            for ai in range(len(AREA_LBLS)):
                npig = int(ngt_k[ai].sum())
                if npig == 0:
                    continue
                for mi, md in enumerate(self.max_dets):
                    mask = pos_in_img < md
                    scores = scores_flat[mask]
                    order = np.argsort(-scores, kind="mergesort")

                    def cat_cols(X):
                        return X[ai][:, mask][:, order]

                    m_k = cat_cols(M_k)
                    ig_k = cat_cols(IG_k)
                    m_ok = cat_cols(M_ok)
                    ig_ok = cat_cols(IG_ok)
                    m_u = cat_cols(M_u)
                    ig_u = cat_cols(IG_u)

                    tps = m_k & ~ig_k
                    fps = ~m_k & ~ig_k
                    okfps = m_ok & ~ig_ok
                    ufps = m_u & ~ig_u

                    tp_sum = np.cumsum(tps, 1).astype(float)
                    fp_sum = np.cumsum(fps, 1).astype(float)
                    ufp_sum = np.cumsum(ufps, 1).astype(float)
                    tf_sum = tp_sum + fp_sum
                    ok_sum = okfps.sum(1).astype(float)

                    for ti in range(T):
                        tp, fp, tf, ufp = tp_sum[ti], fp_sum[ti], tf_sum[ti], ufp_sum[ti]
                        nd = len(tp)
                        if nd:
                            unk_det_as_known[ti, ki, ai, mi] = ufp[-1]
                        ok_det_as_known[ti, ki, ai, mi] = ok_sum[ti]
                        rc = tp / npig
                        pr = tp / (tp + fp + np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0
                        # precision envelope (monotone from the right)
                        pr_env = pr.copy()
                        for i in range(nd - 1, 0, -1):
                            if pr_env[i] > pr_env[i - 1]:
                                pr_env[i - 1] = pr_env[i]
                        inds = np.searchsorted(rc, self.rec_thrs, side="left")
                        q = np.zeros(R)
                        tf_r = np.zeros(R)
                        fo_r = np.zeros(R)
                        ok_mask = inds < nd
                        q[ok_mask] = pr_env[inds[ok_mask]]
                        if nd:
                            clamped = np.minimum(inds, nd - 1)
                            tf_r = tf[clamped]
                            fo_r = ufp[clamped]
                        precision[ti, :, ki, ai, mi] = q
                        tp_plus_fp_cs[ti, :, ki, ai, mi] = tf_r
                        fp_os[ti, :, ki, ai, mi] = fo_r

        # ---- unknown dts ----
        u_precision = -np.ones((T, R, A, M))
        u_recall = -np.ones((T, A, M))
        k_det_as_unk = np.zeros((T, A, M))

        all_k_gts_per_img = defaultdict(list)
        for (img, cat), gts in k_gts.items():
            all_k_gts_per_img[img].extend(gts)

        per_img_u = {}
        for img in self.image_ids:
            dts = _prep_group(unk_dts.get(img, []), max_det)
            gts_u = unk_gts.get(img, [])
            if not dts and not gts_u:
                per_img_u[img] = None
                continue
            per_img_u[img] = (dts, gts_u, all_k_gts_per_img.get(img, []))

        pres_uu, pres_uk = [], []
        for img in self.image_ids:
            grp = per_img_u[img]
            if grp is None:
                continue
            dts, gts_u, gts_k = grp
            pres_uu.append(_precompute_group(dts, gts_u))
            pres_uk.append(_precompute_group(dts, gts_k))
        if pres_uu:
            scores_flat_u = np.concatenate([p["scores"] for p in pres_uu])
            pos_in_img_u = np.concatenate(
                [np.arange(len(p["scores"])) for p in pres_uu]
            )
            M_uu, IG_uu, ngt_u = _match_groups_all_areas(pres_uu, self.iou_thrs)
            M_uk, IG_uk, _ = _match_groups_all_areas(pres_uk, self.iou_thrs)
        for ai in range(len(AREA_LBLS)):
            if not pres_uu:
                continue
            npig = int(ngt_u[ai].sum())
            if npig == 0:
                continue
            for mi, md in enumerate(self.max_dets):
                mask = pos_in_img_u < md
                scores = scores_flat_u[mask]
                order = np.argsort(-scores, kind="mergesort")

                def cat_cols(X):
                    return X[ai][:, mask][:, order]

                m_u = cat_cols(M_uu)
                ig_u = cat_cols(IG_uu)
                m_k = cat_cols(M_uk)
                ig_k = cat_cols(IG_uk)
                tps = m_u & ~ig_u
                fps = ~m_u & ~ig_u
                kfps = m_k & ~ig_k
                tp_sum = np.cumsum(tps, 1).astype(float)
                fp_sum = np.cumsum(fps, 1).astype(float)
                k_sum = np.cumsum(kfps, 1).astype(float)
                for ti in range(T):
                    tp, fp, kf = tp_sum[ti], fp_sum[ti], k_sum[ti]
                    nd = len(tp)
                    if nd:
                        k_det_as_unk[ti, ai, mi] = kf[-1]
                    rc = tp / npig
                    pr = tp / (tp + fp + np.spacing(1))
                    u_recall[ti, ai, mi] = rc[-1] if nd else 0
                    pr_env = pr.copy()
                    for i in range(nd - 1, 0, -1):
                        if pr_env[i] > pr_env[i - 1]:
                            pr_env[i - 1] = pr_env[i]
                    inds = np.searchsorted(rc, self.rec_thrs, side="left")
                    q = np.zeros(R)
                    ok_mask = inds < nd
                    q[ok_mask] = pr_env[inds[ok_mask]]
                    u_precision[ti, :, ai, mi] = q

        return {
            "precision": precision,
            "recall": recall,
            "unk_det_as_known": unk_det_as_known,
            "ok_det_as_known": ok_det_as_known,
            "fp_os": fp_os,
            "tp_plus_fp_cs": tp_plus_fp_cs,
            "u_precision": u_precision,
            "u_recall": u_recall,
            "k_det_as_unk": k_det_as_unk,
        }

    # ------------------------------------------------------------- summarize
    def summarize(self, acc: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
        """30-slot stats vector, same layout as the reference (:933-966)."""
        acc = acc if acc is not None else self.run()
        self._acc = acc
        t05 = int(np.argmin(np.abs(self.iou_thrs - 0.5)))
        t075 = int(np.argmin(np.abs(self.iou_thrs - 0.75)))
        r08 = int(np.argmin(np.abs(self.rec_thrs - 0.8)))
        mi_by_det = {md: i for i, md in enumerate(self.max_dets)}
        m_last = len(self.max_dets) - 1
        m100 = mi_by_det.get(100, m_last)

        def mean_valid(x):
            v = x[x > -1]
            return float(v.mean()) if v.size else -1.0

        def ap(t=None, a=0, m=m_last):
            s = acc["precision"][..., a, m]  # (T, R, K)
            if t is not None:
                s = s[t : t + 1]
            return mean_valid(s)

        def ar(t=None, a=0, m=m_last):
            s = acc["recall"][..., a, m]
            if t is not None:
                s = s[t : t + 1]
            return mean_valid(s)

        def u_ap(t=None, a=0, m=m_last):
            s = acc["u_precision"][..., a, m]
            if t is not None:
                s = s[t : t + 1]
            return mean_valid(s)

        def u_ar(t=None, a=0, m=m_last):
            s = acc["u_recall"][..., a, m]
            if t is not None:
                s = s[t : t + 1]
            return mean_valid(s)

        stats = np.zeros(30)
        stats[0] = ap()
        stats[1] = ap(t=t05)
        stats[2] = ap(t=t075)
        stats[3] = ap(a=1)
        stats[4] = ap(a=2)
        stats[5] = ap(a=3)
        for i in range(min(5, len(self.max_dets))):
            stats[6 + i] = ar(m=i)
        stats[11] = ar(a=1)
        stats[12] = ar(a=2)
        stats[13] = ar(a=3)
        tf = acc["tp_plus_fp_cs"][t05, r08, :, 0, m100]
        fo = acc["fp_os"][t05, r08, :, 0, m100]
        stats[14] = float(fo.mean() / tf.mean()) if tf.mean() > 0 else 0.0  # WI
        stats[15] = float(acc["unk_det_as_known"][t05, :, 0, m100].sum())  # AOSE
        stats[16] = u_ap()
        stats[17] = u_ap(t=t05)
        stats[18] = u_ap(t=t075)
        stats[19] = u_ap(a=1)
        stats[20] = u_ap(a=2)
        stats[21] = u_ap(a=3)
        for i in range(min(5, len(self.max_dets))):
            stats[22 + i] = u_ar(m=i)
        stats[27] = u_ar(a=1)
        stats[28] = u_ar(a=2)
        stats[29] = u_ar(a=3)
        return stats
