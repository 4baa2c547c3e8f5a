"""A configuration, a mix, a cell and a per-layer metric are added by adding
files: in a copy of the benchmark, new files are found by name and no file
that was there changes."""
import hashlib
import importlib.util
import json
import shutil
from pathlib import Path

from perfbench.harness import specs

BENCH = Path(specs.__file__).resolve().parent.parent


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts and ".cache" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    copy = tmp_path / "perfbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digests(copy)
    config = json.loads((copy / "configs" / "r50_fpn_bf16.json").read_text())
    config["name"] = "r50_fpn_bf16_wide"
    (copy / "configs" / "r50_fpn_bf16_wide.json").write_text(json.dumps(config))
    mix = json.loads((copy / "traffic" / "voc_coco_eval.json").read_text())
    mix["gt_per_image"]["mean"] = 30
    (copy / "traffic" / "coco_crowded.json").write_text(json.dumps(mix))
    cell = json.loads((copy / "workloads" / "r50_bf16.eval.json").read_text())
    cell.update(config="r50_fpn_bf16_wide", traffic="coco_crowded", per_layer=["kept_ms.eval"])
    (copy / "workloads" / "r50_bf16.eval_crowded.json").write_text(json.dumps(cell))
    (copy / "metrics" / "kept_ms.py").write_text("def read(run, suffix):\n    return 1.5 if suffix == 'eval' else None\n")

    spec = importlib.util.spec_from_file_location("copied_specs", copy / "harness" / "specs.py")
    copied = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copied)
    got = copied.workload("r50_bf16.eval_crowded")
    assert got["config_spec"]["name"] == "r50_fpn_bf16_wide"
    assert got["traffic_spec"]["gt_per_image"]["mean"] == 30
    assert copied.metric_reader("kept_ms.eval").read(None, "eval") == 1.5
    assert copied.metric_reader("backbone_ms.eval").__name__.endswith("backbone_ms")
    after = _digests(copy)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {Path("configs/r50_fpn_bf16_wide.json"), Path("traffic/coco_crowded.json"),
                                        Path("workloads/r50_bf16.eval_crowded.json"), Path("metrics/kept_ms.py")}


def test_missing_files_are_named():
    import pytest

    with pytest.raises(specs.SpecError, match="no_such_cell"):
        specs.workload("no_such_cell")
    with pytest.raises(specs.SpecError, match="no_such_metric"):
        specs.metric_reader("no_such_metric.eval")
