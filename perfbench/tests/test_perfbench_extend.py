"""A configuration, a mix, a cell, a per-layer metric and a trunk are added
by adding files: in a copy of the benchmark, new files are found by name and
no file that was there changes."""
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench.harness import specs
from perfbench.tests.small import CFG, _merge

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


TOY_REFERENCE = """\"\"\"A toy trunk: four strided convolutions emitting res2..res5.\"\"\"
import torch
from torch import nn

from ..models.resnet import Conv2d

WIDTHS = (8, 16, 16, 32)


class Toy(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype
        for i, (cin, cout) in enumerate(zip((3,) + WIDTHS, WIDTHS)):
            self.add_module(f"res{i + 2}", Conv2d(cin, cout, 3, stride=4 if i == 0 else 2, padding=1))

    def forward(self, x):
        out, x = {}, x.to(self.dtype)
        for i in range(4):
            x = out[f"res{i + 2}"] = torch.relu(getattr(self, f"res{i + 2}")(x))
        return out

    def reset_parameters(self, generator):
        pass


def build(cfg, dtype):
    return Toy(dtype), WIDTHS
"""

TOY_COUNTS = """\"\"\"The toy trunk's convolutions and its FPN.\"\"\"
from perfbench.counts.model import conv_out, fpn

WIDTHS = (8, 16, 16, 32)


def layers(cfg, h, w):
    out, levels, cin = [], {}, 3
    for i, c in enumerate(WIDTHS):
        h, w = conv_out(h, 3, 4 if i == 0 else 2), conv_out(w, 3, 4 if i == 0 else 2)
        out.append((f"res{i + 2}", h * w * c * cin * 9, True, i > 0))
        levels[f"res{i + 2}"] = (h, w, c, True)
        cin = c
    return out + fpn(levels)
"""

# run in a fresh interpreter whose ``perfbench`` is the copy
TOY_RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from perfbench.counts import model
from perfbench.harness import specs
from perfbench.harness.weights import make_weights
from perfbench.reference.model import Reference, skeleton

torch.set_num_threads(2)
config = specs.config("toy_fpn")
cfg = config["cfg"]
net = skeleton(cfg)
state = make_weights(net, config["weights"]["rules"], 5, torch.device("cpu"))
dets = Reference(cfg, state, torch.device("cpu")).detect(
    np.random.RandomState(0).randint(0, 256, (96, 128, 3), dtype=np.uint8), (90, 128), (90, 128))
missing = []
cfg["MODEL"]["BACKBONE"]["NAME"] = "no_such_trunk"
for build in (lambda: skeleton(cfg), lambda: model.eval_flops(cfg, (96, 128), 2)):
    try:
        build()
    except specs.SpecError as e:
        missing.append(str(e))
cfg["MODEL"]["BACKBONE"]["NAME"] = "build_toy_fpn_backbone"
print(json.dumps({
    "specs": specs.__file__,
    "leaves": [k for k in net.state_dict() if k.startswith(("backbone.", "fpn."))][:4],
    "trunk": [n for n, _, _, _ in model.layers(cfg, (96, 128), 2, 10)][:4],
    "eval_flops": model.eval_flops(cfg, (96, 128), 2),
    "by_hand": 2.0 * sum(f for _, f, _, _ in model.layers(cfg, (96, 128), 2, model.proposals_per_image(96, 128, 200))),
    "detections": len(dets.scores), "finite": bool(np.isfinite(dets.scores).all()),
    "missing": missing}))
"""


def test_new_backbone_is_found_by_name(tmp_path):
    copy = tmp_path / "perfbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digests(copy)
    config = json.loads((copy / "configs" / "r50_fpn_bf16.json").read_text())
    _merge(config["cfg"], CFG)
    config["cfg"]["MODEL"]["BACKBONE"]["NAME"] = "build_toy_fpn_backbone"
    config["weights"]["rules"].insert(0, ["^backbone\\..*\\.weight$", "normal", "he_fan_out"])
    (copy / "configs" / "toy_fpn.json").write_text(json.dumps(config))
    (copy / "reference" / "backbones" / "build_toy_fpn_backbone.py").write_text(TOY_REFERENCE)
    (copy / "counts" / "backbones" / "build_toy_fpn_backbone.py").write_text(TOY_COUNTS)

    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", TOY_RUN, str(tmp_path)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(got["specs"]).resolve() == (copy / "harness" / "specs.py").resolve()
    assert got["leaves"] == ["backbone.res2.weight", "backbone.res2.bias", "backbone.res3.weight",
                             "backbone.res3.bias"]
    assert got["trunk"] == ["res2", "res3", "res4", "res5"]
    assert got["eval_flops"] == got["by_hand"] > 0
    assert got["finite"] and got["detections"] > 0
    assert len(got["missing"]) == 2
    assert "perfbench/reference/backbones/no_such_trunk.py is missing" in got["missing"][0]
    assert "perfbench/counts/backbones/no_such_trunk.py is missing" in got["missing"][1]
    after = _digests(copy)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {Path("configs/toy_fpn.json"),
                                        Path("reference/backbones/build_toy_fpn_backbone.py"),
                                        Path("counts/backbones/build_toy_fpn_backbone.py")}
