"""Swin-B + FPN in the benchmark (``configs/swin_b_fpn.json``): the trunk's
operation counts by hand, the reference's module tree against the program's
leaf for leaf, the weight recipe over every leaf, and the two readers of
Swin's stage marks, which find nothing to read without them."""
from types import SimpleNamespace

import pytest
import torch

from perfbench.counts import model
from perfbench.counts.backbones import build_swin_fpn_backbone as swin
from perfbench.harness import specs
from perfbench.harness.weights import leaf_plan
from perfbench.reference.model import skeleton

CONFIG = "swin_b_fpn"


def test_swin_layers_by_hand():
    """Swin-B at window 7 on 64 x 96: 16 x 24 tokens at res2 (21 x 28
    padded), 8 x 12 (14 x 14), 4 x 6 (7 x 7), 2 x 3 (7 x 7)."""
    layers = {n: (f, t, g) for n, f, t, g in swin.swin_fpn(64, 96, 128, (2, 2, 18, 2), 7)}
    assert layers["patch_embed"] == (384 * 128 * 3 * 16, True, False)
    assert layers["stage0_block0.qkv"] == (588 * 128 * 384, True, True)
    assert layers["stage0_block1.attention"] == (2 * 12 * 49 * 49 * 128, True, True)  # 12 windows of 49
    assert layers["stage0_block1.proj"] == (588 * 128 * 128, True, True)
    assert layers["stage0_block1.mlp"] == (2 * 384 * 128 * 512, True, True)
    assert layers["downsample0"] == (96 * 512 * 256, True, True)
    assert layers["stage1_block0.qkv"] == (196 * 256 * 768, True, True)
    assert layers["downsample1"] == (24 * 1024 * 512, True, True)
    assert layers["stage2_block17.attention"] == (2 * 49 * 49 * 512, True, True)
    assert layers["stage2_block17.mlp"] == (2 * 24 * 512 * 2048, True, True)
    assert layers["downsample2"] == (6 * 2048 * 1024, True, True)
    assert layers["stage3_block1.qkv"] == (49 * 1024 * 3072, True, True)
    assert layers["fpn.lateral_res2"] == (384 * 256 * 128, True, True)
    assert layers["fpn.lateral_res5"] == (6 * 256 * 1024, True, True)
    assert layers["fpn.output_res3"] == (96 * 256 * 256 * 9, True, True)
    assert len(layers) == 1 + 4 * 24 + 3 + 8


def test_configuration_counts():
    """The configuration's window and size are read; its trunk at the
    benchmark's bucket is ~351 GMAC an image, 258 of them in res4's 18
    blocks."""
    cfg = specs.config(CONFIG)["cfg"]
    h, w = cfg["TPU"]["TEST_BUCKET"]
    trunk = swin.layers(cfg, h, w)
    assert sum(f for n, f, _, _ in trunk if not n.startswith("fpn")) == 351435055104
    assert sum(f for n, f, _, _ in trunk if n.startswith("stage2_")) == 257920008192
    small = {**cfg, "MODEL": {**cfg["MODEL"], "SWIN": {**cfg["MODEL"]["SWIN"], "WINDOW": 4, "SIZE": "T"}}}
    assert swin.layers(small, 64, 96) == swin.swin_fpn(64, 96, 96, (2, 2, 6, 2), 4)
    assert model.eval_flops(cfg, (h, w), 8) == 8 * model.eval_flops(cfg, (h, w), 1)


def test_reference_leaves_are_the_programs():
    """The reference's detector at Swin-B's widths (meta device) has the
    program's state-dict leaves, in order, with the program's shapes; the
    weight recipe covers every one, the bias tables truncated normal at
    0.02."""
    from openset_rcnn_tpu_torch.config import get_default_cfg
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, OpensetRCNN

    config = specs.config(CONFIG)
    ref = skeleton(config["cfg"])
    cfg = get_default_cfg()
    cfg.merge_from_other(config["cfg"])
    with torch.device("meta"):
        prog = OpensetRCNN(ModelSpec.from_cfg(cfg))
    want = [(k, tuple(v.shape)) for k, v in prog.state_dict().items()]
    assert [(k, tuple(v.shape)) for k, v in ref.state_dict().items()] == want
    assert ("backbone.stage2_block17.attn.rel_bias_table", (169, 16)) in want
    assert ("backbone.downsample2.reduction.weight", (1024, 2048)) in want
    plan = {name: (dist, scale) for name, _, dist, scale, _ in leaf_plan(ref, config["weights"]["rules"])}
    tables = [k for k in plan if k.endswith("rel_bias_table")]
    assert len(tables) == 24 and all(plan[k] == ("trunc_normal", 0.02) for k in tables)
    assert plan["backbone.stage0_block0.norm1.scale"] == ("const", 1.0)
    assert plan["backbone.patch_embed.weight"][0] == "trunc_normal"


class StubMarks:
    """``Marks.between_ms`` over fixed device times of one batch."""

    def __init__(self, at):
        self.at = at

    def between_ms(self, first, last):
        return [self.at[last] - self.at[first]] if first in self.at and last in self.at else []


@pytest.mark.parametrize("name, first, last", [("swin_res2_ms", "begin", "backbone.res2"),
                                               ("swin_res4_ms", "backbone.res3", "backbone.res4")])
def test_readers(name, first, last):
    reader = specs.metric_reader(f"{name}.eval")
    assert reader.read(SimpleNamespace(per_layer_inputs={}), "eval") is None
    r50 = {"begin": 0.0, "backbone": 40.0, "rpn": 45.0, "cascade": 60.0}
    assert reader.read(SimpleNamespace(per_layer_inputs={"marks": StubMarks(r50)}), "eval") is None
    at = {**r50, "backbone.res2": 10.0, "backbone.res3": 14.0, "backbone.res4": 31.0, "backbone.res5": 33.0}
    got = reader.read(SimpleNamespace(per_layer_inputs={"marks": StubMarks(at)}), "eval")
    assert got == at[last] - at[first]
