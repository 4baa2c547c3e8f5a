"""The evaluation slice of the PyTorch port end to end against the JAX
package, on the CPU: ``do_test`` over four synthetic images written by the
port's ``synthetic.py`` (``tests/test_e2e.py``'s ``make_cfg`` scale), with
the fused cascade, with the exact host cascade (``TPU.EVAL_FUSED false``)
and with ``eval_type="proposals"``; the JAX parameters are carried across by
``state_dict_from_jax``. Also GraspNet's class-id maps."""
import jax
import numpy as np
import pytest

from openset_rcnn_tpu.data.catalog import DatasetCatalog as JaxDatasets, MetadataCatalog as JaxMeta
from openset_rcnn_tpu.engine import train_loop as jax_loop
from openset_rcnn_tpu.evaluation.voc_eval import OpensetVocEvaluator as JaxVoc
from openset_rcnn_tpu_torch.config import get_default_cfg as port_default_cfg
from openset_rcnn_tpu_torch.data.catalog import DatasetCatalog as PortDatasets, MetadataCatalog as PortMeta
from openset_rcnn_tpu_torch.data.synthetic import generate_synthetic_dataset
from openset_rcnn_tpu_torch.engine import train_loop as port_loop
from openset_rcnn_tpu_torch.evaluation.inference import Predictor
from openset_rcnn_tpu_torch.evaluation.voc_eval import OpensetVocEvaluator as PortVoc
from openset_rcnn_tpu_torch.models import detector as port_det
from openset_rcnn_tpu_torch.utils.jax_params import state_dict_from_jax
from tests.test_e2e import CLASSES, make_cfg

DATASET = "port_eval_synth"
MODES = ("fused", "host", "proposals")
TOL = 1e-4  # detections: boxes and scores within TOL * max(1, max|want|)


def port_cfg(jcfg):
    cfg = port_default_cfg()
    cfg.merge_from_other(jcfg.to_dict())
    return cfg


def jax_cfg(tmp_path, fused=True):
    cfg = make_cfg(tmp_path)
    cfg.DATASETS.TEST = (DATASET,)
    cfg.TPU.EVAL_BATCH_SIZE = 3  # four images: a full batch and a padded one
    cfg.TPU.EVAL_FUSED = fused
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0  # proposals of positive size from a random init
    # the random init's prototype distances lie in 0.95-1.0: a threshold
    # among them sends proposals down both the known and the unknown branch
    cfg.MODEL.PLN.UNK_THR = 0.99
    # no stage-1 NMS, as every config of the repo sets: the fused cascade
    # (both packages') has none, so it equals the host cascade only so
    cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST = 1.0
    return cfg


def recorded(monkeypatch, cls, sink):
    """Record each image's detections as ``cls.process`` receives them."""
    process = cls.process

    def spy(self, image_id, boxes, scores, classes):
        sink[image_id] = (np.asarray(boxes, np.float64), np.asarray(scores, np.float64), np.asarray(classes))
        return process(self, image_id, boxes, scores, classes)

    monkeypatch.setattr(cls, "process", spy)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_path")
    records = generate_synthetic_dataset(str(tmp / "images"), num_images=4, image_hw=(240, 320),
                                         num_classes=3, seed=99)
    for datasets, meta in ((JaxDatasets, JaxMeta), (PortDatasets, PortMeta)):
        datasets.remove(DATASET)
        datasets.register(DATASET, lambda r=records: r)
        meta.get(DATASET).update(evaluator_type="voc_records", thing_classes=CLASSES)

    rng = np.random.RandomState(5)
    jcfg = jax_cfg(tmp)
    spec = jax_loop.build_model_spec(jcfg)
    module, params = jax_loop.build_module_and_params(jcfg, spec)
    # tempered as in test_torch_port_serving: unsaturated heads, known candidates
    params = jax.tree.map(np.array, params)
    params["box_head"]["fc1"]["kernel"] *= 0.02
    params["classifier"]["cls_score"]["bias"] = rng.normal(0.0, 1.5, 4).astype(np.float32)
    keys = port_det.build_model(port_det.ModelSpec.from_cfg(port_cfg(jcfg)), "cpu").state_dict().keys()
    state = state_dict_from_jax(params, keys)

    out = {}
    for mode in MODES:
        cfg = jax_cfg(tmp, fused=mode != "host")
        eval_type = "proposals" if mode == "proposals" else "openset"
        dets_j, dets_p = {}, {}
        with pytest.MonkeyPatch.context() as mp:
            recorded(mp, JaxVoc, dets_j)
            recorded(mp, PortVoc, dets_p)
            want = jax_loop.do_test(cfg, module, params, spec, eval_type=eval_type)[DATASET]
            got = port_loop.do_test(port_cfg(cfg), state, eval_type=eval_type, device="cpu")[DATASET]
        out[mode] = dict(want=want, got=got, dets_want=dets_j, dets_got=dets_p)
    yield out
    JaxDatasets.remove(DATASET)
    PortDatasets.remove(DATASET)


def multiset(boxes, scores, classes):
    """Rows (class, score, box) sorted, so that tied detections compare
    whatever order the two cascades put them in."""
    rows = np.concatenate([classes[:, None].astype(np.float64), scores[:, None], boxes], 1)
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows.reshape(0, 6)


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_do_test_detections_match_jax(runs, mode):
    run = runs[mode]
    want, got = run["dets_want"], run["dets_got"]
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    n_known = n_unknown = 0
    for image_id, (wb, ws, wc) in want.items():
        gb, gs, gc = got[image_id]
        assert len(gc) == len(wc), f"image {image_id}: {len(gc)} detections, JAX {len(wc)}"
        a, b = multiset(gb, gs, gc), multiset(wb, ws, wc)
        np.testing.assert_array_equal(a[:, 0], b[:, 0], err_msg=f"image {image_id}: classes")
        scale = max(1.0, float(np.abs(b[:, 1:]).max())) if len(b) else 1.0
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=0, atol=TOL * scale, err_msg=f"image {image_id}")
        n_unknown += int((wc == len(CLASSES) - 1).sum())
        n_known += int((wc < len(CLASSES) - 1).sum())
    assert n_known > 0 and n_unknown > 0, (n_known, n_unknown)  # both branches reach the evaluator


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_do_test_metrics_match_jax(runs, mode):
    run = runs[mode]
    assert set(run["got"]) == set(run["want"]) >= {"WI", "AOSE", "AP@K", "AP@U", "R@K", "R@U", "mAP"}
    assert run["got"] == run["want"]


def test_do_test_fused_matches_host(runs):
    """The fused cascade's detections equal the host cascade's (no image
    overflows the known-candidate slot at this size)."""
    assert runs["fused"]["got"] == runs["host"]["got"]
    for image_id, (hb, hs, hc) in runs["host"]["dets_got"].items():
        fb, fs, fc = runs["fused"]["dets_got"][image_id]
        np.testing.assert_allclose(multiset(fb, fs, fc), multiset(hb, hs, hc), rtol=0, atol=1e-5)


def test_do_test_proposal_ar_matches_jax(runs):
    want, got = runs["proposals"]["want"], runs["proposals"]["got"]
    assert set(got) == set(want) >= {"AR@100", "AR@1000", "AR@100-small", "AR@1000-large"}
    for key, w in want.items():
        if np.isnan(w):
            assert np.isnan(got[key]), key
        else:
            assert abs(got[key] - w) <= 1e-6, (key, got[key], w)
    assert np.isfinite(got["AR@100"]) and got["AR@1000"] > 0


def test_graspnet_id_map_and_class_table_match_jax():
    from openset_rcnn_tpu.config import get_default_cfg as jax_default_cfg

    path = "configs/GraspNet/openset_rcnn_R50_FPN_128k.yaml"
    jcfg, pcfg = jax_default_cfg(), port_default_cfg()
    jcfg.merge_from_file(path)
    pcfg.merge_from_file(path)
    assert not pcfg.OPENDET_BENCHMARK
    spec = port_det.ModelSpec.from_cfg(pcfg)
    want = jax_loop.build_model_spec(jcfg).id_map
    assert spec.id_map == tuple(int(x) for x in want)
    assert sum(i >= 0 for i in spec.id_map) == spec.num_known_classes + 1  # the known classes and background
    # the table do_test hands the cascade (first test dataset), and Predictor's
    known_ids, contig = jax_loop._known_dataset_meta(jcfg, jcfg.DATASETS.TEST[0])
    table = np.asarray(sorted(contig[i] for i in known_ids))
    np.testing.assert_array_equal(port_loop.class_id_table(pcfg), table)
    post_cfg = Predictor(pcfg, device="cpu").post_cfg
    np.testing.assert_array_equal(post_cfg.class_id_table, table)
    assert post_cfg.unknown_id == jcfg.MODEL.ROI_HEADS.UNKNOWN_ID == 1000
