"""The port's data slice against the JAX package, on the CPU: the synthetic
writer, the resize rule, ``DetectionTransform`` (PIL and cv2 resampling,
flips, BGR/RGB), ``collate``/``BatchMeta``/``EvalLoader`` with a padded final
batch in both buckets, ``device_prefetch`` on the CPU, the VOC and COCO
readers, the GraspNet tables and the builtin registration. Images and
integer arrays must be equal, boxes exactly."""
import json
import os

import numpy as np
import pytest
import torch

from openset_rcnn_tpu.data import builtin as jax_builtin, catalog as jax_catalog
from openset_rcnn_tpu.data import coco as jax_coco, graspnet_meta as jax_grasp, voc as jax_voc
from openset_rcnn_tpu.data import loader as jax_loader, synthetic as jax_synth, transforms as jax_tf
from openset_rcnn_tpu_torch.data import builtin as port_builtin, catalog as port_catalog
from openset_rcnn_tpu_torch.data import coco as port_coco, graspnet_meta as port_grasp, voc as port_voc
from openset_rcnn_tpu_torch.data import loader as port_loader, synthetic as port_synth, transforms as port_tf

EXAMPLE_FIELDS = ("image", "image_hw", "original_hw", "bucket_hw", "boxes", "classes", "gt_valid", "image_id")


def mixed_records(tmp_path, n_land=5, n_port=3):
    """Landscape and portrait synthetic images, in an interleaved order."""
    land = port_synth.generate_synthetic_dataset(str(tmp_path / "land"), n_land, (200, 300), num_classes=3, seed=1)
    port = port_synth.generate_synthetic_dataset(str(tmp_path / "port"), n_port, (300, 200), num_classes=3, seed=2)
    for i, r in enumerate(port):
        r["image_id"] = 100 + i
    records = []
    while land or port:
        records += land[:2] + port[:1]
        land, port = land[2:], port[1:]
    return records


def test_synthetic_dataset_matches_jax(tmp_path):
    import cv2

    kw = dict(num_images=3, image_hw=(120, 160), num_classes=4, max_objects=5, seed=7, color_seed=3)
    got = port_synth.generate_synthetic_dataset(str(tmp_path / "port"), **kw)
    want = jax_synth.generate_synthetic_dataset(str(tmp_path / "jax"), **kw)
    for g, w in zip(got, want, strict=True):
        assert os.path.basename(g.pop("file_name")) == os.path.basename(w["file_name"])
        assert g == {k: v for k, v in w.items() if k != "file_name"}
    for name in sorted(os.listdir(tmp_path / "jax")):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / name)), cv2.imread(str(tmp_path / "jax" / name)))


@pytest.mark.parametrize("h, w, short, max_size", [(480, 640, 800, 1333), (400, 1000, 800, 1333), (640, 480, 800, 1333),
                                                   (800, 1200, 800, 1333), (1200, 800, 800, 1333), (333, 500, 600, 1000),
                                                   (240, 320, 128, 256), (101, 99, 64, 97)])
def test_resize_shortest_edge_matches_jax(h, w, short, max_size):
    assert port_tf.resize_shortest_edge(h, w, short, max_size) == jax_tf.resize_shortest_edge(h, w, short, max_size)


@pytest.mark.parametrize("interp, flip, fmt", [("pil", False, "BGR"), ("cv2", False, "BGR"), ("pil", True, "BGR"),
                                               ("cv2", True, "RGB")])
def test_detection_transform_matches_jax(tmp_path, interp, flip, fmt):
    records = mixed_records(tmp_path, 2, 2)
    kw = dict(min_sizes=(96, 128), max_size=200, bucket_hw=(160, 224), max_gt=4, flip=flip, fmt=fmt, interp=interp)
    got_tf, want_tf = port_tf.DetectionTransform(**kw), jax_tf.DetectionTransform(**kw)
    for seed, rec in enumerate(records):
        got = got_tf(rec, np.random.RandomState(seed))
        want = want_tf(rec, np.random.RandomState(seed))
        for f in EXAMPLE_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert got.image.dtype == np.uint8 and got.image_hw != got.original_hw  # resized
    assert port_tf.DetectionTransform(**kw)({"file_name": str(tmp_path / "missing.png")}, np.random.RandomState(0)) is None


def test_read_image_is_the_one_reader(tmp_path):
    """A transform that supplies decoded pixels (as chip_smoke's does) gives
    what the file reader gives for the same pixels."""
    rec = mixed_records(tmp_path, 1, 0)[0]
    kw = dict(min_sizes=(128,), max_size=200, bucket_hw=(160, 224), max_gt=4, flip=False)
    pixels = port_tf.DetectionTransform(**kw).read_image(rec)

    class InMemory(port_tf.DetectionTransform):
        def read_image(self, record):
            return record["pixels"]

    got = InMemory(**kw)({**rec, "file_name": None, "pixels": pixels}, np.random.RandomState(0))
    want = jax_tf.DetectionTransform(**kw)(rec, np.random.RandomState(0))
    for f in EXAMPLE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("batch_size, pad_final", [(2, True), (4, True), (4, False)])
def test_eval_loader_matches_jax(tmp_path, batch_size, pad_final):
    records = mixed_records(tmp_path)
    kw = dict(min_sizes=(128,), max_size=200, bucket_hw=(160, 224), max_gt=4, flip=False)
    got = list(port_loader.EvalLoader(records, port_tf.DetectionTransform(**kw), batch_size, pad_final))
    want = list(jax_loader.EvalLoader(records, jax_tf.DetectionTransform(**kw), batch_size, pad_final))
    assert len(got) == len(want)
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gb.images.dtype == torch.uint8 and gb.image_hw.dtype == torch.float32
        np.testing.assert_array_equal(gb.images.numpy(), np.asarray(wb.images))
        np.testing.assert_array_equal(gb.image_hw.numpy(), np.asarray(wb.image_hw))
        for f in ("boxes", "classes", "valid"):
            np.testing.assert_array_equal(getattr(gb.gt, f).numpy(), np.asarray(getattr(wb.gt, f)), err_msg=f)
        assert vars(gm) == vars(wm)
    # both buckets; with padding, a final partial batch repeats its last example
    assert {m.bucket_hw for _, m in got} == {(160, 224), (224, 160)}
    partial = [(b, m) for b, m in got if len(m.image_ids) < batch_size]
    if pad_final:
        assert partial and all(b.images.shape[0] == batch_size for b, _ in got)
        for b, m in partial:
            assert torch.equal(b.images[-1], b.images[len(m.image_ids) - 1])
    ids = [i for _, m in got for i in m.image_ids]
    assert sorted(ids) == sorted(r["image_id"] for r in records)


def test_device_prefetch_on_the_cpu_passes_batches_through(tmp_path):
    records = mixed_records(tmp_path)
    loader = port_loader.EvalLoader(records, port_tf.DetectionTransform((128,), 200, (160, 224), 4, False), 3)
    want = list(loader)
    got = list(port_loader.device_prefetch(loader, "cpu"))
    assert len(got) == len(want)
    for (gb, gm), (wb, wm) in zip(got, want):
        assert torch.equal(gb.images, wb.images) and torch.equal(gb.gt.boxes, wb.gt.boxes)
        assert gm.image_ids == wm.image_ids

    def broken():
        yield want[0]
        raise OSError("unreadable batch")

    it = port_loader.device_prefetch(broken(), "cpu")
    next(it)
    with pytest.raises(OSError, match="unreadable"):
        next(it)


def write_voc_tree(root):
    """A VOC directory: two images, known, unknown and difficult objects, one
    object of a class outside the list."""
    objects = {
        "000001": [("dog", (10, 20, 110, 220), 0), ("zebra", (5, 5, 50, 60), 0), ("person", (1, 1, 9, 9), 1)],
        "000002": [("notaclass", (3, 4, 30, 40), 0), ("car", (100, 50, 300, 200), None)],
    }
    os.makedirs(root / "Annotations")
    os.makedirs(root / "ImageSets" / "Main")
    (root / "ImageSets" / "Main" / "test.txt").write_text("000001\n\n000002\n")
    for image_id, objs in objects.items():
        body = "".join(
            f"<object><name>{name}</name>"
            + (f"<difficult>{d}</difficult>" if d is not None else "")
            + "<bndbox>" + "".join(f"<{k}>{v}</{k}>" for k, v in zip(("xmin", "ymin", "xmax", "ymax"), box))
            + "</bndbox></object>"
            for name, box, d in objs
        )
        xml = f"<annotation><size><width>500</width><height>375</height><depth>3</depth></size>{body}</annotation>"
        (root / "Annotations" / f"{image_id}.xml").write_text(xml)


def test_voc_readers_match_jax(tmp_path):
    write_voc_tree(tmp_path)
    assert port_voc.VOC_COCO_CATEGORIES == jax_voc.VOC_COCO_CATEGORIES and len(port_voc.VOC_COCO_CATEGORIES) == 81
    assert port_voc.VOC_CLASSES == jax_voc.VOC_CLASSES
    got = port_voc.load_voc_instances(str(tmp_path), "test", port_voc.VOC_COCO_CATEGORIES)
    want = jax_voc.load_voc_instances(str(tmp_path), "test", jax_voc.VOC_COCO_CATEGORIES)
    assert got == want and [len(r["annotations"]) for r in got] == [3, 1]
    got = port_voc.load_voc_gt_for_eval(str(tmp_path), "test")
    assert got == jax_voc.load_voc_gt_for_eval(str(tmp_path), "test")
    assert got[1]["class_names"] == ["notaclass", "car"] and got[0]["difficult"] == [False, False, True]


@pytest.mark.parametrize("keep", [None, [1, 3]])
def test_coco_reader_matches_jax(tmp_path, keep):
    data = {
        "images": [{"id": 1, "file_name": "a.png", "height": 10, "width": 12},
                   {"id": 7, "file_name": "b.png", "height": 20, "width": 30}],
        "categories": [{"id": 1, "name": "x"}, {"id": 2, "name": "y"}, {"id": 3, "name": "z"}],
        "annotations": [
            {"id": 1, "image_id": 1, "category_id": 1, "bbox": [0, 0, 5, 5], "area": 25},
            {"id": 2, "image_id": 1, "category_id": 2, "bbox": [1, 1, 5, 5], "area": 25},
            {"id": 3, "image_id": 7, "category_id": 3, "bbox": [2.5, 1, 4, 6], "area": 24},
            {"id": 4, "image_id": 7, "category_id": 1, "bbox": [0, 0, 9, 9], "area": 81, "iscrowd": 1},
        ],
    }
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(data))
    got = port_coco.load_coco_instances(str(path), str(tmp_path), keep_category_ids=keep)
    assert got == jax_coco.load_coco_instances(str(path), str(tmp_path), keep_category_ids=keep)
    assert sum(len(r["annotations"]) for r in got) == (3 if keep is None else 2)
    c = port_coco.CocoJson(data)
    assert c.category_ids() == jax_coco.CocoJson(data).category_ids() and len(c.img_to_anns[7]) == 2


def test_graspnet_tables_match_jax():
    assert port_grasp.GRASPNET_CATEGORIES == jax_grasp.GRASPNET_CATEGORIES
    assert port_grasp.GRASPNET_KNOWN_IDS == jax_grasp.GRASPNET_KNOWN_IDS and len(port_grasp.GRASPNET_KNOWN_IDS) == 28
    assert port_grasp.graspnet_metadata() == jax_grasp.graspnet_metadata()


def test_builtin_registration_matches_jax(monkeypatch):
    """Both packages register the same names with the same metadata (each
    into fresh catalogs, so no other test's registrations interfere)."""
    out = []
    for builtin, catalog in ((port_builtin, port_catalog), (jax_builtin, jax_catalog)):
        datasets, meta = catalog._DatasetCatalog(), catalog._MetadataCatalog()
        monkeypatch.setattr(builtin, "DatasetCatalog", datasets)
        monkeypatch.setattr(builtin, "MetadataCatalog", meta)
        monkeypatch.setattr(builtin, "_REGISTERED", False)
        builtin.register_builtin_datasets("/nonexistent_root")
        out.append((datasets.list(), {n: dict(meta.get(n)) for n in datasets.list()}))
    assert out[0] == out[1]
    names, meta = out[0]
    assert {"graspnet_train", "graspnet_test_6", "voc_coco_20_40_test", "voc_2007_trainval"} <= set(names)
    assert meta["graspnet_train"]["evaluator_type"] == "coco" and meta["voc_coco_val"]["evaluator_type"] == "pascal_voc"
