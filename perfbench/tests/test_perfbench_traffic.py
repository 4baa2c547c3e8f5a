"""The traffic generator: the same seed gives the same inputs, another seed
the same amount of work in another order, and every input within the mix's
stated parameters."""
import numpy as np
import pytest

from perfbench.harness import specs, traffic


def _small(name):
    spec = dict(specs.traffic(name))
    spec["pool"] = 40 if spec["kind"] == "image_files" else 3
    return spec


@pytest.mark.parametrize("name", ["voc_train", "voc_coco_eval"])
def test_image_files(tmp_path, name):
    spec = _small(name)
    a = traffic.generate(spec, 12345678901, str(tmp_path / "a"))
    b = traffic.generate(spec, 12345678901, str(tmp_path / "b"))
    c = traffic.generate(spec, 98765, str(tmp_path / "c"))
    strip = lambda recs: [{k: v for k, v in r.items() if k != "file_name"} for r in recs]
    assert strip(a.records) == strip(b.records)
    assert all(np.array_equal(a.read_image(x), b.read_image(y)) for x, y in zip(a.records, b.records))
    assert strip(a.records) != strip(c.records)
    for data in (a, c):
        sizes = sorted((r["height"], r["width"]) for r in data.records)
        want = sorted((h, w) for (h, w, _), n in zip(spec["sizes"], traffic.counts_of([s for *_, s in spec["sizes"]],
                                                                                    spec["pool"])) for _ in range(n))
        assert sizes == want
        counts = sorted(len(r["annotations"]) for r in data.records)
        assert counts == sorted(traffic.geometric_quantiles(spec["pool"], spec["gt_per_image"]["mean"],
                                                            spec["gt_per_image"]["min"], spec["gt_per_image"]["max"]))
        known, unknown = spec["classes"]["known"], spec["classes"].get("unknown", 0)
        for r in data.records:
            img = data.read_image(r)
            assert img.shape == (r["height"], r["width"], 3) and img.dtype == np.uint8
            for a_ in r["annotations"]:
                x1, y1, x2, y2 = a_["bbox"]
                assert 0 <= x1 < x2 <= r["width"] and 0 <= y1 < y2 <= r["height"]
                assert min(x2 - x1, y2 - y1) >= spec["box_side"]["min"] - 1e-6
                assert 0 <= a_["category_id"] < known + unknown
        if unknown:
            classes = [a_["category_id"] for r in data.records for a_ in r["annotations"]]
            assert any(c >= known for c in classes) and any(c < known for c in classes)


def test_frames_are_decoded_and_seeded():
    spec = _small("frames_720p")
    a, b = traffic.generate(spec, 7), traffic.generate(spec, 7)
    assert [r["file_name"] for r in a.records] == [r["file_name"] for r in b.records]
    for x, y in zip(a.records, b.records):
        assert np.array_equal(a.read_image(x), b.read_image(y))
        assert a.read_image(x).shape == (720, 1280, 3) and x["annotations"] == y["annotations"]
        gt = spec["gt_per_image"]
        assert gt["min"] <= len(x["annotations"]) <= gt["max"]
        for a_ in x["annotations"]:
            x1, y1, x2, y2 = a_["bbox"]
            assert 0 <= x1 < x2 <= 1280 and 0 <= y1 < y2 <= 720
            assert min(x2 - x1, y2 - y1) >= spec["box_side"]["min"] - 1e-6
    assert not np.array_equal(a.read_image(a.records[0]), traffic.generate(spec, 8).read_image(a.records[0]))


def test_shares_and_quantiles():
    assert traffic.counts_of([0.7, 0.3], 512) == [358, 154]
    assert sum(traffic.counts_of([0.35, 0.15, 0.3, 0.1, 0.1], 256)) == 256
    q = traffic.geometric_quantiles(10000, 3.0, 1, 42)
    assert q.min() == 1 and q.max() <= 42 and abs(q.mean() - 3.0) < 0.1


def test_cycle_gives_each_record_an_id_of_its_own():
    recs = [{"image_id": i, "file_name": f"f{i}"} for i in range(3)]
    out = traffic.cycle(recs, 2, 5)
    assert [r["image_id"] for r in out] == [2, 3, 4, 5, 6]
    assert [r["file_name"] for r in out] == ["f2", "f0", "f1", "f2", "f0"]
