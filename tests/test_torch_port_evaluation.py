"""The port's evaluators, host cascade and native evaluation core against
the JAX package, on the CPU: the same detections and GT through both give
equal metric dicts (NaN at the same keys), equal keep lists and equal
detections. The cases mirror tests/test_voc_eval.py, test_os_cocoeval.py,
test_evalcore_native.py, test_postprocess.py and test_proposal_ar.py, with
random cases beside them. Last, the port's fused cascade followed by
``finalize_serve_image`` equals its exact host cascade."""
import json
import logging
import math
import os

import numpy as np
import pytest
import torch

from openset_rcnn_tpu.data.catalog import MetadataCatalog as JaxMeta
from openset_rcnn_tpu.evaluation import coco_eval as jax_coco_eval, evalcore_binding as jax_eb
from openset_rcnn_tpu.evaluation import os_cocoeval as jax_oc, postprocess as jax_pp, proposals as jax_props
from openset_rcnn_tpu.evaluation import voc_eval as jax_voc
from openset_rcnn_tpu_torch import _native
from openset_rcnn_tpu_torch.data.catalog import MetadataCatalog as PortMeta
from openset_rcnn_tpu_torch.evaluation import coco_eval as port_coco_eval, evalcore_binding as port_eb
from openset_rcnn_tpu_torch.evaluation import os_cocoeval as port_oc, postprocess as port_pp, proposals as port_props
from openset_rcnn_tpu_torch.evaluation import voc_eval as port_voc
from openset_rcnn_tpu_torch.models.serving import fused_cascade
from openset_rcnn_tpu_torch.ops.nms import nms_keep_plain
from openset_rcnn_tpu_torch.structures import RawDetections
from tests.test_torch_port_serving import make_raw


def assert_same_metrics(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert (isinstance(w, float) and math.isnan(w) and math.isnan(g)) or g == w, (k, g, w)


# ------------------------------------------------------------ VOC evaluator

GT = {  # tests/test_voc_eval.py's two images
    "img1": ([[0, 0, 10, 10], [20, 20, 30, 30], [50, 50, 60, 60]], ["cat", "dog", "zebra"], [False, False, False]),
    "img2": ([[0, 0, 10, 10], [30, 30, 40, 40]], ["cat", "bird"], [True, False]),
}
VOC_CASES = {  # (image, box in GT coordinates, score, class)
    "golden": [("img1", [0, 0, 10, 10], 0.9, 0), ("img2", [0, 0, 10, 10], 0.8, 0), ("img1", [50, 50, 60, 60], 0.7, 0),
               ("img1", [20, 20, 30, 30], 0.6, 1), ("img1", [50, 50, 60, 60], 0.5, 2)],
    "duplicate": [("img1", [0, 0, 10, 10], 0.9, 0), ("img1", [0, 0, 10, 10], 0.8, 0)],
    "wi": [("img1", [50, 50, 60, 60], 0.9, 0)],
    "unknown_last_id": [("img1", [50, 50, 60, 60], 0.9, 2), ("img2", [30, 30, 40, 40], 0.8, 2)],
    "out_of_table_id": [("img1", [50, 50, 60, 60], 0.9, 80)],
    "none": [],
}


def voc_random_case(rng, n_images=6):
    names = ["cat", "dog", "bird", "zebra", "car"]
    gt, dets = {}, []
    for i in range(n_images):
        n = rng.randint(1, 6)
        xy = rng.uniform(0, 200, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(10, 80, (n, 2))], 1).round()
        gt[f"r{i}"] = (boxes.tolist(), [names[j] for j in rng.randint(0, 5, n)], (rng.rand(n) < 0.2).tolist())
        for b in boxes:
            for _ in range(rng.randint(0, 3)):  # jittered hits, duplicates and misses
                dets.append((f"r{i}", (b + rng.normal(0, 4, 4)).tolist(), float(rng.rand()), int(rng.randint(0, 3))))
    return gt, dets


def voc_run(module, gt, dets, output_dir=None, resume=False):
    ev = module.OpensetVocEvaluator(["cat", "dog", "unknown"], num_known_classes=2, output_dir=output_dir)
    for image_id, (boxes, names, difficult) in gt.items():
        ev.add_ground_truth(image_id, boxes, names, difficult)
    for image_id, box, score, cls in dets:
        b = np.asarray([box], np.float64)
        b[:, :2] -= 1.0  # loader coordinates; the evaluator adds the 1 back
        ev.process(image_id, b, np.asarray([score]), np.asarray([cls]))
    return ev.evaluate(resume=resume)


@pytest.mark.parametrize("case", [*VOC_CASES, "random"])
def test_voc_evaluator_matches_jax(case):
    gt, dets = voc_random_case(np.random.RandomState(0)) if case == "random" else (GT, VOC_CASES[case])
    got, want = voc_run(port_voc, gt, dets), voc_run(jax_voc, gt, dets)
    assert_same_metrics(got, want)
    if case == "golden":
        assert got["AP@K"] == 100.0 and got["AOSE"] == 1.0 and got["AP@U"] == 50.0


def test_voc_evaluator_resume_matches_jax(tmp_path):
    gt, dets = voc_random_case(np.random.RandomState(1))
    first = voc_run(port_voc, gt, dets, str(tmp_path / "port"))
    assert_same_metrics(first, voc_run(jax_voc, gt, dets, str(tmp_path / "jax")))
    resumed = voc_run(port_voc, gt, [], str(tmp_path / "port"), resume=True)
    assert_same_metrics(resumed, voc_run(jax_voc, gt, [], str(tmp_path / "jax"), resume=True))
    assert_same_metrics(resumed, first)
    with pytest.raises(FileNotFoundError):
        voc_run(port_voc, gt, [], str(tmp_path / "nope"), resume=True)


def test_voc_ap_and_overlaps_match_jax(rng):
    for _ in range(5):
        rec = np.sort(rng.rand(20))
        prec = rng.rand(20)
        assert port_voc.voc_ap(rec, prec) == jax_voc.voc_ap(rec, prec)
        gt = rng.uniform(0, 50, (7, 4))
        gt[:, 2:] += gt[:, :2]
        box = gt[rng.randint(7)] + rng.normal(0, 3, 4)
        np.testing.assert_array_equal(port_voc.voc_overlaps(gt, box), jax_voc.voc_overlaps(gt, box))


# ------------------------------------------------------------ COCO evaluators

def coco_anns_golden():
    gt = [
        {"id": 1, "image_id": 1, "category_id": 1, "bbox": [0, 0, 10, 10], "area": 100},
        {"id": 2, "image_id": 1, "category_id": 1000, "bbox": [50, 50, 10, 10], "area": 100},
        {"id": 3, "image_id": 2, "category_id": 2, "bbox": [0, 0, 20, 20], "area": 400},
    ]
    dt = [
        {"image_id": 1, "category_id": 1, "bbox": [0, 0, 10, 10], "score": 0.9},
        {"image_id": 1, "category_id": 1, "bbox": [50, 50, 10, 10], "score": 0.8},
        {"image_id": 2, "category_id": 2, "bbox": [0, 0, 20, 20], "score": 0.7},
        {"image_id": 1, "category_id": 1000, "bbox": [50, 50, 10, 10], "score": 0.6},
    ]
    return gt, dt, [1, 2], [1, 2]


def coco_anns_misclassified():
    gt = [{"id": 1, "image_id": 1, "category_id": 1, "bbox": [0, 0, 10, 10], "area": 100},
          {"id": 2, "image_id": 1, "category_id": 1000, "bbox": [50, 50, 10, 10], "area": 100}]
    return gt, [{"image_id": 1, "category_id": 1, "bbox": [50, 50, 10, 10], "score": 0.9}], [1], [1]


def coco_anns_unknown_recall():
    gt = [{"id": 1, "image_id": 1, "category_id": 1000, "bbox": [0, 0, 10, 10], "area": 100},
          {"id": 2, "image_id": 1, "category_id": 1000, "bbox": [50, 50, 10, 10], "area": 100}]
    return gt, [{"image_id": 1, "category_id": 1000, "bbox": [0, 0, 10, 10], "score": 0.9}], [1], [1]


def coco_anns_random(rng=None, n_images=6):
    """GT of known categories 1-3 and unknown 1000 over all area ranges,
    some crowd; detections jittered around them plus strays."""
    rng = rng or np.random.RandomState(2)
    gt, dt = [], []
    for img in range(1, n_images + 1):
        for _ in range(rng.randint(1, 7)):
            w, h = np.exp(rng.uniform(np.log(8), np.log(300), 2))
            x, y = rng.uniform(0, 400, 2)
            cat = int(rng.choice([1, 2, 3, 1000]))
            gt.append({"id": len(gt) + 1, "image_id": img, "category_id": cat, "bbox": [x, y, w, h],
                       "area": w * h, "iscrowd": int(rng.rand() < 0.1)})
            for _ in range(rng.randint(0, 3)):
                dcat = cat if rng.rand() < 0.7 else int(rng.choice([1, 2, 3, 1000]))
                jit = rng.normal(0, 0.1, 4) * [w, h, w, h]
                dt.append({"image_id": img, "category_id": dcat, "bbox": list(np.asarray([x, y, w, h]) + jit),
                           "score": float(rng.rand())})
        dt.append({"image_id": img, "category_id": 2, "bbox": [10.0, 10.0, 30.0, 30.0], "score": float(rng.rand())})
    return gt, dt, list(range(1, n_images + 1)), [1, 2, 3]


COCO_CASES = {"golden": coco_anns_golden, "misclassified_unknown": coco_anns_misclassified,
              "unknown_recall": coco_anns_unknown_recall, "random": coco_anns_random}


@pytest.mark.parametrize("case", COCO_CASES)
def test_open_set_coco_eval_matches_jax(case):
    gt, dt, image_ids, known = COCO_CASES[case]()
    out = []
    for oc in (port_oc, jax_oc):
        ev = oc.OpenSetCocoEval(gt_anns=gt, dt_anns=dt, image_ids=image_ids, known_cat_ids=known, unknown_id=1000)
        acc = ev.run()
        out.append((ev.summarize(acc), acc))
    (got, got_acc), (want, want_acc) = out
    np.testing.assert_array_equal(got, want)
    assert set(got_acc) == set(want_acc)
    for k in want_acc:
        np.testing.assert_array_equal(np.asarray(got_acc[k]), np.asarray(want_acc[k]), err_msg=k)
    if case == "golden":
        assert got[0] == pytest.approx(1.0) and got[15] == 1.0 and got[5] == -1.0


def test_coco_primitives_match_jax(rng):
    dt = rng.uniform(0, 50, (6, 4))
    gt = rng.uniform(0, 50, (5, 4))
    crowd = np.asarray([0, 1, 0, 0, 1])
    np.testing.assert_array_equal(port_oc.bbox_iou_xywh(dt, gt, crowd), jax_oc.bbox_iou_xywh(dt, gt, crowd))
    ious = rng.rand(9, 5)
    ignore = np.asarray([0, 0, 0, 1, 1])
    for a, b in zip(port_oc.greedy_match(ious, ignore, crowd, port_oc.IOU_THRS),
                    jax_oc.greedy_match(ious, ignore, crowd, jax_oc.IOU_THRS)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def coco_dataset(tmp_path):
    """A registered COCO-json test set in both packages' catalogs: five
    categories, three of them known."""
    gt, _, image_ids, _ = coco_anns_random(np.random.RandomState(3))
    cats = [1, 2, 3, 4, 5]
    for a in gt:
        if a["category_id"] == 1000:
            a["category_id"] = 4 + a["id"] % 2  # unknown categories of the dataset
    data = {"images": [{"id": i, "file_name": f"{i}.png", "height": 500, "width": 500} for i in image_ids],
            "categories": [{"id": c, "name": f"c{c}"} for c in cats], "annotations": gt}
    path = tmp_path / "gt.json"
    path.write_text(json.dumps(data))
    name = "port_coco_eval_test"
    meta = dict(json_file=str(path), thing_classes=[f"c{c}" for c in cats],
                thing_dataset_id_to_contiguous_id={c: i for i, c in enumerate(cats)})
    for catalog in (PortMeta, JaxMeta):
        catalog.get(name).update(meta)
    return name, gt


@pytest.mark.parametrize("eval_type", ["openset", "cls_agn_unk"])
def test_coco_evaluator_matches_jax(tmp_path, coco_dataset, eval_type):
    name, gt = coco_dataset
    rng = np.random.RandomState(4)
    dets = []
    for a in gt:  # contiguous ids for known detections, 1000 for unknown
        x, y, w, h = a["bbox"]
        cls = a["category_id"] - 1 if a["category_id"] <= 3 else 1000
        box = np.asarray([[x, y, x + w, y + h]]) + rng.normal(0, 2, (1, 4))
        dets.append((a["image_id"], box, np.asarray([rng.rand()]), np.asarray([cls if rng.rand() < 0.8 else 1])))
    out = {}
    for label, module in (("port", port_coco_eval), ("jax", jax_coco_eval)):
        ev = module.OpensetCocoEvaluator(name, known_ids=[1, 2, 3], output_dir=str(tmp_path / label),
                                         eval_type=eval_type)
        for image_id, b, s, c in dets:
            ev.process(image_id, b, s, c)
        first = ev.evaluate()
        again = module.OpensetCocoEvaluator(name, known_ids=[1, 2, 3], output_dir=str(tmp_path / label),
                                            eval_type=eval_type).evaluate(resume=True)
        assert_same_metrics(again, first)
        out[label] = first
    assert_same_metrics(out["port"], out["jax"])
    assert any(math.isfinite(v) for v in out["port"].values())
    if eval_type == "openset":
        for f in ("known_precision_bbox.npy", "unknown_recall_bbox.npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f))
    with pytest.raises(ValueError, match="not supported"):
        port_coco_eval.OpensetCocoEvaluator(name, eval_type="Closeset")


# ------------------------------------------------------------ proposal AR

PROPOSAL_CASES = {  # tests/test_proposal_ar.py's cases: (gt, proposals, limits)
    "perfect": ([[0, 0, 50, 50], [100, 100, 200, 200]], [[0, 0, 50, 50], [100, 100, 200, 200]], (100,)),
    "partial": ([[0, 0, 100, 100], [300, 300, 400, 400]], [[0, 0, 100, 100]], (100,)),
    "limit": ([[0, 0, 100, 100]], [[500, 500, 600, 600], [0, 0, 100, 100]], (1, 100)),
    "iou_sweep": ([[0.0, 0.0, 100.0, 100.0]], [[0.0, 0.0, 100.0, 70.0]], (100,)),
}


@pytest.mark.parametrize("case", [*PROPOSAL_CASES, "random"])
def test_proposal_ar_matches_jax(case):
    if case == "random":
        rng = np.random.RandomState(5)
        gt_map, props = {}, []
        for i in range(8):
            side = np.exp(rng.uniform(np.log(10), np.log(400), (rng.randint(0, 6), 2)))
            xy = rng.uniform(0, 500, side.shape)
            gt_map[i] = np.concatenate([xy, xy + side], 1)
            n = rng.randint(1, 300)
            pxy = rng.uniform(0, 600, (n, 2))
            props.append({"image_id": i, "boxes": np.concatenate([pxy, pxy + rng.uniform(5, 400, (n, 2))], 1),
                          "scores": rng.rand(n)})
        kw = dict(limits=(10, 100, 1000))
    else:
        gt, boxes, limits = PROPOSAL_CASES[case]
        gt_map = {1: np.asarray(gt, float)}
        props = [{"image_id": 1, "boxes": np.asarray(boxes, float), "scores": np.linspace(0.9, 0.8, len(boxes))}]
        kw = dict(limits=limits, areas=("all",))
    got = port_props.evaluate_box_proposals(props, gt_map, **kw)
    assert_same_metrics(got, jax_props.evaluate_box_proposals(props, gt_map, **kw))
    if case == "iou_sweep":
        assert got["AR@100"] == 50.0


# ------------------------------------------------------------ NMS and the native core

@pytest.mark.parametrize("native", [True, False])
def test_numpy_nms_matches_jax(monkeypatch, native):
    if native:
        assert port_eb.available()
    else:  # the numpy fallback where no compiler is found
        def missing(*args):
            raise _native.CompilerMissing("no host compiler")

        monkeypatch.setattr(port_eb, "nms_native", missing)
    rng = np.random.RandomState(6)
    for n, thresh in ((3, 0.5), (40, 0.5), (200, 0.3), (200, 0.7), (64, 1.0)):
        xy = rng.uniform(0, 80, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))], 1)
        scores = rng.randint(0, 20, n) / 20.0  # ties
        np.testing.assert_array_equal(port_pp.numpy_nms(boxes, scores, thresh), jax_pp.numpy_nms(boxes, scores, thresh))
        classes = rng.randint(0, 4, n)
        np.testing.assert_array_equal(port_pp.batched_numpy_nms(boxes, scores, classes, thresh),
                                      jax_pp.batched_numpy_nms(boxes, scores, classes, thresh))
    assert len(port_pp.batched_numpy_nms(np.zeros((0, 4)), np.zeros(0), np.zeros(0, int), 0.5)) == 0


def test_evalcore_binding_matches_jax():
    assert port_eb.available() and jax_eb.available()
    assert os.path.dirname(_native.library_path("evalcore")) == os.path.join(
        os.path.dirname(os.path.dirname(port_eb.__file__)), "_build")
    rng = np.random.RandomState(7)
    for _ in range(10):
        D, G = rng.randint(1, 20), rng.randint(1, 12)
        ious = rng.rand(D, G)
        ignore = (rng.rand(G) < 0.3).astype(np.int32)
        ignore = np.sort(ignore)
        crowd = (rng.rand(G) < 0.2).astype(np.int32)
        for a, b in zip(port_eb.greedy_match_native(ious, ignore, crowd, port_oc.IOU_THRS),
                        jax_eb.greedy_match_native(ious, ignore, crowd, jax_oc.IOU_THRS)):
            np.testing.assert_array_equal(a, b)
        n = rng.randint(2, 60)
        xy = rng.uniform(0, 80, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))], 1)
        np.testing.assert_array_equal(port_eb.nms_native(boxes, 0.5), jax_eb.nms_native(boxes, 0.5))
    # the batched (image x area) matcher, through os_cocoeval's dispatch
    pres = []
    for _ in range(12):
        dts = [dict(bbox=[*rng.uniform(0, 200, 2), *rng.uniform(2, 150, 2)], score=float(s))
               for s in -np.sort(-rng.rand(rng.randint(0, 15)))]
        gts = []
        for _ in range(rng.randint(0, 8)):
            w, h = rng.uniform(2, 150, 2)
            gts.append(dict(bbox=[*rng.uniform(0, 200, 2), w, h], area=w * h, iscrowd=int(rng.rand() < 0.2)))
        pres.append((dts, gts))
    got = port_oc._match_groups_all_areas([port_oc._precompute_group(*p) for p in pres], port_oc.IOU_THRS)
    want = jax_oc._match_groups_all_areas([jax_oc._precompute_group(*p) for p in pres], jax_oc.IOU_THRS)
    for a, b in zip(got, want):
        for x, y in zip(a, b) if isinstance(a, list) else [(a, b)]:
            np.testing.assert_array_equal(x, y)


def test_unexpected_native_error_is_logged_once(rng, monkeypatch, caplog):
    """As in the JAX package: an unexpected failure of the binding falls
    back to numpy and says so once."""
    def boom(*args, **kwargs):
        raise ValueError("synthetic binding bug")

    monkeypatch.setattr(port_eb, "greedy_match_native", boom)
    monkeypatch.setattr(port_oc, "_GREEDY_NATIVE_WARNED", False)
    ious, ignore, crowd = rng.rand(5, 3), np.zeros(3, np.int32), np.zeros(3, np.int32)
    with caplog.at_level(logging.WARNING, logger=port_oc.__name__):
        got = port_oc.greedy_match(ious, ignore, crowd, port_oc.IOU_THRS)
        port_oc.greedy_match(ious, ignore, crowd, port_oc.IOU_THRS)
    assert len([r for r in caplog.records if "synthetic binding bug" in r.getMessage()]) == 1
    for a, b in zip(got, jax_oc.greedy_match(ious, ignore, crowd, jax_oc.IOU_THRS)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ host cascade

def raw_image(rng, P=64, K=3):
    xy = rng.uniform(0, 300, (P, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(20, 120, (P, 2))], 1).astype(np.float32)
    boxes[3] = np.nan  # a non-finite box is dropped
    logits = rng.randn(P, K + 1).astype(np.float32) * 2
    return dict(boxes=boxes, objectness=rng.uniform(0, 1, P).astype(np.float32),
                min_dist=rng.uniform(0, 1, P).astype(np.float32), pln_class=rng.randint(0, K, P),
                known_probs=(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32),
                valid=rng.rand(P) > 0.1)


@pytest.mark.parametrize("stage1_nms, table, topk", [(1.0, None, 50), (0.5, None, 50), (1.0, [5, 9, 17], 7),
                                                     (0.7, [5, 9, 17], 1000)])
def test_host_cascade_matches_jax(stage1_nms, table, topk):
    rng = np.random.RandomState(8)
    kw = dict(obj_score_thresh=0.05, stage1_nms_thresh=stage1_nms, detections_per_image=40, unk_thr=0.5,
              known_topk=topk, unknown_topk=topk, unknown_id=80 if table is None else 1000,
              class_id_table=None if table is None else np.asarray(table))
    for _ in range(3):
        r = raw_image(rng)
        args = [r[k] for k in ("boxes", "objectness", "min_dist", "pln_class", "known_probs", "valid")]
        got = port_pp.postprocess_image(*args, (400, 400), (250, 330), port_pp.PostprocessConfig(**kw))
        want = jax_pp.postprocess_image(*args, (400, 400), (250, 330), jax_pp.PostprocessConfig(**kw))
        for f in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert (got.classes == kw["unknown_id"]).any() and (got.classes != kw["unknown_id"]).any()
        # the fused path's host finalize, on a padded detection set
        D = 20
        valid = rng.rand(D) > 0.3
        classes = np.where(rng.rand(D) < 0.3, kw["unknown_id"], rng.randint(0, 3, D))
        fargs = (r["boxes"][:D], r["objectness"][:D], classes, valid & np.isfinite(r["boxes"][:D]).all(1),
                 (400, 400), (250, 330))
        got = port_pp.finalize_serve_image(*fargs, port_pp.PostprocessConfig(**kw))
        want = jax_pp.finalize_serve_image(*fargs, jax_pp.PostprocessConfig(**kw))
        for f in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_postprocess_config_from_cfg_matches_jax():
    from openset_rcnn_tpu.config import get_default_cfg as jax_cfg
    from openset_rcnn_tpu_torch.config import get_default_cfg as port_cfg

    for path, opendet in (("configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml", True),
                          ("configs/GraspNet/openset_rcnn_R50_FPN_128k.yaml", False)):
        jc, pc = jax_cfg(), port_cfg()
        jc.merge_from_file(path)
        pc.merge_from_file(path)
        assert vars(port_pp.PostprocessConfig.from_cfg(pc, opendet)) == vars(jax_pp.PostprocessConfig.from_cfg(jc, opendet))


def multiset(boxes, scores, classes):
    rows = np.concatenate([classes[:, None].astype(np.float64), scores[:, None], boxes], 1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("table", [None, [5, 9, 17, 21, 30]])
def test_fused_cascade_then_finalize_equals_host_cascade(table):
    """The port's fused cascade plus ``finalize_serve_image`` against its
    exact host cascade on the same raw detections: equal per-image
    multisets when no image overflows the known-candidate slot."""
    raw = make_raw(np.random.RandomState(9), 3, 300, 5)
    unknown_id = 80 if table is None else 1000
    cfg = port_pp.PostprocessConfig(obj_score_thresh=0.05, detections_per_image=1000, unk_thr=0.5, known_topk=50,
                                    unknown_topk=50, unknown_id=unknown_id,
                                    class_id_table=None if table is None else np.asarray(table))
    out = fused_cascade(RawDetections(**{k: torch.from_numpy(v) for k, v in raw.items()}), obj_thresh=0.05,
                        unk_thr=0.5, known_topk=50, unknown_topk=50, unknown_id=unknown_id, stage1_topk=1000,
                        max_known_candidates=2000, keep_fn=nms_keep_plain)
    assert int(out.known_overflow.sum()) == 0
    input_hw, output_hw = (400, 400), (250, 330)
    for i in range(3):
        fin = port_pp.finalize_serve_image(out.boxes[i].numpy(), out.scores[i].numpy(), out.classes[i].numpy(),
                                           out.valid[i].numpy(), input_hw, output_hw, cfg)
        host = port_pp.postprocess_image(*(raw[k][i] for k in ("boxes", "objectness", "min_dist", "pln_class",
                                                                 "known_probs", "valid")), input_hw, output_hw, cfg)
        assert len(fin.classes) == len(host.classes) > 0
        np.testing.assert_allclose(multiset(fin.boxes, fin.scores, fin.classes),
                                   multiset(host.boxes, host.scores, host.classes), rtol=0, atol=1e-5)
