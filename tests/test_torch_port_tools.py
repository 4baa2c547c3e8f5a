"""The port's tools (``openset_rcnn_tpu_torch/tools``), the visualizer and the
custom operators of K1 and K4 against the JAX package, on the CPU.

One setting (``tests/test_e2e.py::make_cfg`` at a 128 x 160 bucket, three
synthetic images of 96 x 128, 120 x 160 and 80 x 120 written with cv2) and
one weights file: JAX's seeded init, tempered as in
``test_torch_port_eval_path.py``, written as a d2 ``.pth`` by
``torch_weights.to_d2``; both packages read it through ``MODEL.WEIGHTS``.

* ``predict`` against JAX's ``tools/predict.py``: per image, the detections
  as multisets (class exactly, score and box within ``TOL`` of
  ``test_torch_port_eval_path.py`` scaled as there, plus one step of the
  JSON's rounding: 1e-4 for scores, 1e-2 for boxes), names exactly; both
  write their ``--viz`` overlays.
* ``--eval-only`` with ``MODEL.WEIGHTS x.pth`` gives the metrics of the same
  weights as a port ``.pt``.
* ``export_serving`` on the CPU, single and ``--split``: the loaded artifact
  against the live ``Predictor`` at the JAX round-trip tolerances of
  ``tests/test_export_serving.py`` (boxes rtol 1e-3 / atol 1e-2, scores rtol
  1e-4 / atol 2e-3, integers and masks exactly), against JAX's live
  ``build_serving_fn`` on the same ``.pth`` as per-image multisets, and its
  graph holds the ``roi_align_fwd`` and ``nms_keep`` operator nodes (one
  and two), with no unrolled scan.
* ``convert_checkpoint``'s ``.pt`` loads to the converter's state bitwise.
* The visualizer: ``draw_boxes`` bitwise JAX's, ``visualize_dataset`` the
  same files, byte for byte.
* The operators: fake implementations' shapes and dtypes on meta tensors,
  and the CPU implementations equal the plain versions.
* Without a card, ``predict`` and ``export_serving`` raise unless asked for
  the CPU.
"""
import collections
import importlib.util
import json
import os
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from openset_rcnn_tpu.data.catalog import DatasetCatalog as JaxDatasets, MetadataCatalog as JaxMeta
from openset_rcnn_tpu.engine import train_loop as jax_loop
from openset_rcnn_tpu.utils import visualizer as jax_viz
from openset_rcnn_tpu_torch import train as cli
from openset_rcnn_tpu_torch.config import get_default_cfg as port_default_cfg
from openset_rcnn_tpu_torch.data.catalog import DatasetCatalog as PortDatasets, MetadataCatalog as PortMeta
from openset_rcnn_tpu_torch.data.synthetic import generate_synthetic_dataset
from openset_rcnn_tpu_torch.device import entry_numerics
from openset_rcnn_tpu_torch.engine.checkpoint import load_weights_file
from openset_rcnn_tpu_torch.evaluation.inference import Predictor
from openset_rcnn_tpu_torch.models import detector as port_det
from openset_rcnn_tpu_torch.ops import nms, roi_align
from openset_rcnn_tpu_torch.tools import convert_checkpoint, export_serving, predict
from openset_rcnn_tpu_torch.utils import torch_weights, visualizer as port_viz
from openset_rcnn_tpu_torch.utils.jax_params import state_dict_from_jax
from tests.port_threads import share_cores  # noqa: F401 (autouse)
from tests.test_e2e import CLASSES, make_cfg
from tests.test_torch_port_eval_path import TOL, multiset

ROOT = Path(__file__).resolve().parents[1]
DATASET = "port_tools_test"
IMAGE_HW = [(96, 128), (120, 160), (80, 120)]
BATCH = 2
ROUNDING = {"scores": 1e-4, "boxes_xyxy": 1e-2}  # the JSON's rounding step
# tests/test_export_serving.py's round-trip tolerances
EXPORT_TOL = {"boxes": dict(rtol=1e-3, atol=1e-2), "scores": dict(rtol=1e-4, atol=2e-3)}


def jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_cfg(tmp):
    cfg = make_cfg(tmp)
    cfg.DATASETS.TEST = (DATASET,)
    cfg.TPU.TRAIN_BUCKET = cfg.TPU.TEST_BUCKET = (128, 160)
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 96, 160
    cfg.TPU.EVAL_BATCH_SIZE = BATCH
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0  # proposals of positive size from a random init
    cfg.MODEL.PLN.UNK_THR = 0.99  # both the known and the unknown branch (see test_torch_port_eval_path)
    return cfg


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tools")
    records = []
    for i, hw in enumerate(IMAGE_HW):
        records += generate_synthetic_dataset(str(tmp / f"images{i}"), num_images=1, image_hw=hw, num_classes=3,
                                              seed=40 + i)
    images = tmp / "images"
    images.mkdir()
    for i, rec in enumerate(records):
        os.replace(rec["file_name"], images / f"img{i}.png")
        rec["file_name"], rec["image_id"] = str(images / f"img{i}.png"), i
    for datasets, meta in ((JaxDatasets, JaxMeta), (PortDatasets, PortMeta)):
        datasets.remove(DATASET)
        datasets.register(DATASET, lambda r=records: r)
        meta.get(DATASET).update(evaluator_type="voc_records", thing_classes=CLASSES)

    jcfg = jax_cfg(tmp)
    spec = jax_loop.build_model_spec(jcfg)
    _, params = jax_loop.build_module_and_params(jcfg, spec)
    params = jax.tree.map(np.array, params)
    params["box_head"]["fc1"]["kernel"] *= 0.02
    params["classifier"]["cls_score"]["bias"] = np.random.RandomState(5).normal(0.0, 1.5, 4).astype(np.float32)
    pcfg = port_default_cfg()
    pcfg.merge_from_other(jcfg.to_dict())
    keys = port_det.build_model(port_det.ModelSpec.from_cfg(pcfg), "cpu").state_dict().keys()
    state = state_dict_from_jax(params, keys)
    pth = tmp / "model_final.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in torch_weights.to_d2(state).items()}}, pth)
    config = tmp / "config.yaml"
    config.write_text(jcfg.dump())
    yield dict(tmp=tmp, records=records, images=images, jcfg=jcfg, pcfg=pcfg, state=state, pth=str(pth),
               config=str(config))
    JaxDatasets.remove(DATASET)
    PortDatasets.remove(DATASET)


def read_json(directory):
    return {p.stem: json.loads(p.read_text()) for p in sorted(Path(directory).glob("*.json"))}


def json_multiset(record):
    return multiset(np.asarray(record["boxes_xyxy"], np.float64).reshape(-1, 4), np.asarray(record["scores"]),
                    np.asarray(record["classes"]))


def test_predict_matches_jax_predict(setting, monkeypatch):
    out_j, out_p = setting["tmp"] / "predict_jax", setting["tmp"] / "predict_port"
    args = ["--config-file", setting["config"], "--input", str(setting["images"]), "--viz"]
    weights = ["MODEL.WEIGHTS", setting["pth"]]
    monkeypatch.setattr(sys, "argv", ["predict.py", *args, "--output", str(out_j), *weights])
    jax_tool("predict").main()
    results = predict.main([*args, "--output", str(out_p), *weights], device="cpu")
    want, got = read_json(out_j), read_json(out_p)
    assert sorted(got) == sorted(want) == ["img0", "img1", "img2"] and len(results) == 3
    kinds = set()
    for name in want:
        w, g = want[name], got[name]
        assert g["file_name"] == w["file_name"] and sorted(g["names"]) == sorted(w["names"]), name
        rw, rg = json_multiset(w), json_multiset(g)
        assert rg.shape == rw.shape and len(rw), name
        np.testing.assert_array_equal(rg[:, 0], rw[:, 0], err_msg=name)
        scale = lambda x: max(1.0, float(np.abs(x).max()))
        np.testing.assert_allclose(rg[:, 1], rw[:, 1], rtol=0, atol=TOL * scale(rw[:, 1]) + ROUNDING["scores"])
        np.testing.assert_allclose(rg[:, 2:], rw[:, 2:], rtol=0,
                                   atol=TOL * scale(rw[:, 2:]) + ROUNDING["boxes_xyxy"])
        kinds |= set(g["names"])
        for out in (out_j, out_p):
            assert cv2.imread(str(out / f"{name}_viz.jpg")).shape == (*IMAGE_HW[int(name[-1])], 3)
    assert "unknown" in kinds and kinds - {"unknown"}  # both branches


def test_eval_only_pth_gives_the_metrics_of_the_same_pt(setting):
    pt = setting["tmp"] / "converted.pt"
    model = port_det.build_model(port_det.ModelSpec.from_cfg(setting["pcfg"]), "cpu", seed=3)
    torch.save({"model": torch_weights.convert_torch_checkpoint(setting["pth"], model)}, pt)
    metrics = []
    for weights in (setting["pth"], str(pt)):
        argv = ["--config-file", setting["config"], "--eval-only", "MODEL.WEIGHTS", weights,
                "OUTPUT_DIR", str(setting["tmp"] / f"eval_{Path(weights).suffix[1:]}")]
        metrics.append(cli.main(cli.get_parser().parse_args(argv), device="cpu")[DATASET])
    assert metrics[0] == metrics[1] and metrics[0]


@pytest.fixture(scope="module")
def exported(setting):
    """Both export modes through the CLI, the loaded programs' outputs on
    the first two images, and the live references'."""
    from openset_rcnn_tpu_torch.data import DetectionTransform

    cfg = setting["pcfg"]
    transform = DetectionTransform(min_sizes=(cfg.INPUT.MIN_SIZE_TEST,), max_size=cfg.INPUT.MAX_SIZE_TEST,
                                   bucket_hw=tuple(cfg.TPU.TEST_BUCKET), max_gt=1, flip=False,
                                   fmt=cfg.INPUT.FORMAT, interp=cfg.TPU.RESIZE_INTERP)
    examples = [transform(rec, np.random.RandomState(0)) for rec in setting["records"][:BATCH]]
    images = torch.from_numpy(np.stack([ex.image for ex in examples]).astype(np.float32))
    image_hw = torch.tensor([ex.image_hw for ex in examples], dtype=torch.float32)

    live = Predictor(cfg, "cpu", setting["state"])(images, image_hw)
    jax_cfg_w = setting["jcfg"].clone()
    jax_cfg_w.MODEL.WEIGHTS = setting["pth"]
    infer, _ = jax_tool("export_serving").build_serving_fn(jax_cfg_w)
    jax_live = jax.tree.map(np.asarray, infer(images.numpy(), image_hw.numpy()))

    out = {}
    for mode in ("single", "split"):
        path = str(setting["tmp"] / f"serving_{mode}.pt2")
        flags = ["--split"] if mode == "split" else []
        written = export_serving.main(["--config-file", setting["config"], "--batch", str(BATCH), "--out", path,
                                       "--platform", "cpu", *flags, "MODEL.WEIGHTS", setting["pth"]])
        programs = []
        for p in written:
            with open(p, "rb") as f:
                programs.append(torch.export.load(f))
        with torch.inference_mode(), entry_numerics():
            modules = [export_serving.load(p) for p in written]
            result = modules[0](images, image_hw)
            if mode == "split":
                result = modules[1](*result)
        out[mode] = dict(programs=programs, result=result)
    return dict(out=out, live=live, jax_live=jax_live)


@pytest.mark.parametrize("mode", ["single", "split"])
def test_export_round_trip_matches_predictor(exported, mode):
    result, live = exported["out"][mode]["result"], exported["live"]
    boxes, scores, classes, valid, known_overflow = result
    for name, got in (("boxes", boxes), ("scores", scores)):
        torch.testing.assert_close(got, getattr(live, name), **EXPORT_TOL[name])
    for name, got in (("classes", classes), ("valid", valid), ("known_overflow", known_overflow)):
        assert torch.equal(got, getattr(live, name)), name
    assert valid.any()


@pytest.mark.parametrize("mode", ["single", "split"])
def test_export_matches_jax_build_serving_fn(exported, mode):
    boxes, scores, classes, valid, _ = [t.numpy() for t in exported["out"][mode]["result"]]
    want = exported["jax_live"]
    for b in range(BATCH):
        rw = multiset(want.boxes[b][want.valid[b]], want.scores[b][want.valid[b]], want.classes[b][want.valid[b]])
        rg = multiset(boxes[b][valid[b]], scores[b][valid[b]], classes[b][valid[b]])
        assert rg.shape == rw.shape and len(rw)
        np.testing.assert_array_equal(rg[:, 0], rw[:, 0])
        scale = lambda x: max(1.0, float(np.abs(x).max()))
        np.testing.assert_allclose(rg[:, 1], rw[:, 1], rtol=0, atol=TOL * scale(rw[:, 1]))
        np.testing.assert_allclose(rg[:, 2:], rw[:, 2:], rtol=0, atol=TOL * scale(rw[:, 2:]))


@pytest.mark.parametrize("mode", ["single", "split"])
def test_export_graph_holds_the_custom_ops(exported, mode):
    """K1 once and K4 twice, as operator nodes, and not the plain versions:
    the plain NMS scan, unrolled by a trace, would add a ``bitwise_not`` (of
    ``~suppressed[:, i]``) for every box of either call."""
    nodes = [n for p in exported["out"][mode]["programs"] for n in p.graph.nodes if n.op == "call_function"]
    counts = collections.Counter(str(n.target) for n in nodes)
    assert counts["openset_rcnn.roi_align_fwd.default"] == 1 and counts["openset_rcnn.nms_keep.default"] == 2
    boxes = [n.args[0].meta["val"].shape[1] for n in nodes if str(n.target) == "openset_rcnn.nms_keep.default"]
    assert sorted(boxes) == [100, 300]  # stage-1 top-k, and its known (box, class) candidates
    assert counts["aten.bitwise_not.default"] + counts["aten.bitwise_or.Tensor"] < min(boxes) / 10, counts


def test_convert_checkpoint_round_trip(setting):
    dst = str(setting["tmp"] / "convert.pt")
    assert convert_checkpoint.main(["--config-file", setting["config"], "--src", setting["pth"], "--dst", dst]) == dst
    model = port_det.build_model(port_det.ModelSpec.from_cfg(setting["pcfg"]), "cpu", seed=7)
    load_weights_file(dst, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, setting["state"][k]), k


def test_visualizer_matches_jax(setting):
    rng = np.random.RandomState(6)
    image = rng.randint(0, 255, (120, 160, 3)).astype(np.uint8)
    boxes = rng.uniform(0, 150, (6, 4))
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 40, (6, 2))
    kw = dict(labels=["a", "b", "unknown", "d", "e", "f"], classes=np.asarray([0, 1, 3, 2, 3, 0]),
              scores=rng.uniform(0, 1, 6), unknown_id=3)
    got, want = port_viz.draw_boxes(image, boxes, **kw), jax_viz.draw_boxes(image, boxes, **kw)
    assert np.array_equal(got, want) and not np.array_equal(got, image)
    assert np.array_equal(port_viz.draw_boxes(image, boxes), jax_viz.draw_boxes(image, boxes))

    dirs = setting["tmp"] / "viz_jax", setting["tmp"] / "viz_port"
    jax_viz.visualize_dataset(DATASET, str(dirs[0]), num=2)
    port_viz.visualize_dataset(DATASET, str(dirs[1]), num=2)
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) == ["0.jpg", "1.jpg"]
    for name in names:
        assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes(), name


def test_custom_ops_fake_shapes_and_cpu_route():
    """The fake implementations give (B, R, P, P, C) f32 and (B, N) bool
    without data; on CPU tensors the operators are the plain versions."""
    B, R, C = 2, 5, 8
    meta = [torch.empty((B, 64 // s, 96 // s, C), dtype=torch.bfloat16, device="meta") for s in (4, 8, 16, 32)]
    boxes = torch.empty((B, R, 4), device="meta")
    out = torch.ops.openset_rcnn.roi_align_fwd(meta, boxes, torch.empty((B, R), dtype=torch.int32, device="meta"),
                                               [4, 8, 16, 32], 7, 2)
    assert (out.shape, out.dtype, out.device.type) == ((B, R, 7, 7, C), torch.float32, "meta")
    keep = torch.ops.openset_rcnn.nms_keep(boxes, torch.empty((B, R), dtype=torch.bool, device="meta"), 0.5)
    assert (keep.shape, keep.dtype) == ((B, R), torch.bool)

    g = torch.Generator().manual_seed(0)
    feats = [torch.randn((B, 64 // s, 96 // s, C), generator=g).to(torch.bfloat16) for s in (4, 8, 16, 32)]
    xy = torch.rand((B, R, 2), generator=g) * 60
    boxes = torch.cat([xy, xy + 4 + torch.rand((B, R, 2), generator=g) * 30], -1)
    levels = roi_align.assign_levels(boxes)
    for ratio in (2, roi_align.ADAPTIVE):
        assert torch.equal(roi_align.roi_align(feats, boxes, levels, (4, 8, 16, 32), 7, ratio),
                           roi_align.roi_align_plain(feats, boxes, levels, (4, 8, 16, 32), 7, ratio))
    valid = torch.rand((B, R), generator=g) > 0.2
    assert torch.equal(nms.nms_keep(boxes, valid, 0.3), nms.nms_keep_plain(boxes, valid, 0.3))
    assert roi_align.roi_align.launches == roi_align.roi_align.adaptive_launches == nms.nms_keep.launches == 0


def test_tools_raise_without_a_gpu_unless_asked_for_the_cpu(setting, monkeypatch):
    """No fallback: without a card, predict and export_serving raise unless
    the caller asks for the CPU (``device="cpu"``, ``--platform cpu``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(["--config-file", setting["config"], "--input", str(setting["images"]),
                      "--output", str(setting["tmp"] / "no_gpu")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_serving.main(["--config-file", setting["config"], "--out", str(setting["tmp"] / "no_gpu.pt2")])
