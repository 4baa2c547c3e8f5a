"""MViTv2-L + FPN in the benchmark (``configs/mvitv2_l_fpn.json``): the
trunk's operation counts by hand at a small size and at the configuration's,
the reference's module tree against the program's leaf for leaf, the weight
recipe over every leaf, and the three readers of MViT's stage marks, which
find nothing to read without them."""
from types import SimpleNamespace

import pytest
import torch

from perfbench.counts import model
from perfbench.counts.backbones import build_mvit_fpn_backbone as mvit
from perfbench.harness import specs
from perfbench.harness.weights import leaf_plan
from perfbench.reference.model import skeleton

CONFIG = "mvitv2_l_fpn"


def test_mvit_layers_by_hand():
    """A small MViT (width 16, one head, stage ends 1/3/5/7, window 8, kv
    stride 4) on 88 x 120: 22 x 30 tokens; block 0 attends in 3 x 4
    windows of 8 x 8 queries against 2 x 2 keys; block 2 pools q to 11 x 15
    (windows of 4, 12 of them) and widens 16 -> 32; block 3 is global, 11 x
    15 queries against 3 x 4 keys."""
    layers = {n: (f, t, g) for n, f, t, g in mvit.mvit_fpn(88, 120, 16, 8, 1, (1, 3, 5, 7), 3, 4, 8, 4.0, 32)}
    assert layers["patch_embed"] == (660 * 16 * 3 * 49, True, False)
    assert layers["block0.qkv"] == (660 * 16 * 48, True, True)
    assert layers["block0.pool"] == ((660 + 2 * 48) * 16 * 9, True, True)  # q 22 x 30, k and v 6 x 8
    assert layers["block0.attention"] == (2 * 12 * 64 * 4 * 16, True, True)
    assert layers["block0.rel_pos"] == (12 * 64 * (2 + 2) * 16, True, True)
    assert layers["block0.proj"] == (660 * 16 * 16, True, True)
    assert layers["block0.mlp"] == (2 * 660 * 16 * 64, True, True)
    assert "block0.shortcut" not in layers and "block1.shortcut" not in layers
    assert layers["block2.qkv"] == (660 * 16 * 96, True, True)  # on the input grid, widened
    assert layers["block2.shortcut"] == (660 * 16 * 32, True, True)
    assert layers["block2.pool"] == (3 * 165 * 32 * 9, True, True)  # q, k and v all 11 x 15
    assert layers["block2.attention"] == (2 * 12 * 16 * 16 * 32, True, True)
    assert layers["block2.proj"] == (165 * 32 * 32, True, True)
    assert layers["block3.pool"] == ((165 + 2 * 12) * 32 * 9, True, True)
    assert layers["block3.attention"] == (2 * 165 * 12 * 32, True, True)
    assert layers["block3.rel_pos"] == (165 * (3 + 4) * 32, True, True)
    assert layers["block7.attention"] == (2 * 12 * 12 * 128, True, True)  # 3 x 4 against 3 x 4
    assert layers["fpn.lateral_res2"] == (660 * 256 * 16, True, True)
    assert layers["fpn.lateral_res5"] == (12 * 256 * 128, True, True)
    assert layers["fpn.output_res4"] == (48 * 256 * 256 * 9, True, True)
    assert len(layers) == 1 + 6 * 8 + 3 + 8


def test_configuration_counts():
    """MViTv2-L at the benchmark's bucket: ~952 GMAC (1.90 TFLOP) a trunk,
    72% of it in stage 3's 36 blocks; the size keys are read."""
    cfg = specs.config(CONFIG)["cfg"]
    h, w = cfg["TPU"]["TEST_BUCKET"]
    trunk = [layer for layer in mvit.layers(cfg, h, w) if not layer[0].startswith("fpn")]
    total = sum(f for _, f, _, _ in trunk)
    assert total == 952172299008
    stage3 = sum(f for n, f, _, _ in trunk if n.startswith("block") and 8 <= int(n.split(".")[0][5:]) <= 43)
    assert 0.71 < stage3 / total < 0.73
    small = {**cfg, "MODEL": {**cfg["MODEL"], "MVIT": {**cfg["MODEL"]["MVIT"], "EMBED_DIM": 16, "DEPTH": 8,
                                                       "NUM_HEADS": 1, "LAST_BLOCK_INDEXES": [1, 3, 5, 7],
                                                       "ADAPTIVE_WINDOW_SIZE": 8, "PRETRAIN_SIZE": 32}}}
    assert mvit.layers(small, 88, 120) == mvit.mvit_fpn(88, 120, 16, 8, 1, (1, 3, 5, 7), 3, 4, 8, 4.0, 32)
    assert model.eval_flops(cfg, (h, w), 8) == 8 * model.eval_flops(cfg, (h, w), 1)


def test_reference_leaves_are_the_programs():
    """The reference's detector at MViTv2-L's widths (meta device) has the
    program's state-dict leaves, in order, with the program's shapes; the
    weight recipe covers every one, the relative-position tables truncated
    normal at 0.02, the depthwise pooling kernels lecun at fan-in 9."""
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
    assert ("backbone.block7.attn.rel_pos_h", (55, 72)) in want
    assert ("backbone.block44.proj.weight", (1152, 576)) in want
    assert ("backbone.block0.attn.pool_k.weight", (72, 1, 3, 3)) in want
    assert sum(v.numel() for k, v in ref.state_dict().items() if k.startswith("backbone.")) == 212484384
    plan = {name: (dist, scale) for name, _, dist, scale, _ in leaf_plan(ref, config["weights"]["rules"])}
    tables = [k for k in plan if ".rel_pos_" in k]
    assert len(tables) == 96 and all(plan[k] == ("trunc_normal", 0.02) for k in tables)
    assert plan["backbone.block0.attn.pool_q.weight"] == ("trunc_normal", pytest.approx((1 / 9) ** 0.5 / 0.87962566103423978))
    assert plan["backbone.block0.norm1.scale"] == ("const", 1.0)
    assert plan["backbone.patch_embed.bias"] == ("const", 0.0)


class StubMarks:
    """``Marks.between_ms`` over fixed device times of one batch."""

    def __init__(self, at):
        self.at = at

    def between_ms(self, first, last):
        return [self.at[last] - self.at[first]] if first in self.at and last in self.at else []


@pytest.mark.parametrize("name, first, last", [("mvit_res2_ms", "begin", "backbone.res2"),
                                               ("mvit_res3_ms", "backbone.res2", "backbone.res3"),
                                               ("mvit_res4_ms", "backbone.res3", "backbone.res4")])
def test_readers(name, first, last):
    reader = specs.metric_reader(f"{name}.eval")
    assert reader.read(SimpleNamespace(per_layer_inputs={}), "eval") is None
    r50 = {"begin": 0.0, "backbone": 40.0, "rpn": 45.0, "cascade": 60.0}
    assert reader.read(SimpleNamespace(per_layer_inputs={"marks": StubMarks(r50)}), "eval") is None
    at = {**r50, "backbone.res2": 10.0, "backbone.res3": 14.0, "backbone.res4": 31.0, "backbone.res5": 33.0}
    got = reader.read(SimpleNamespace(per_layer_inputs={"marks": StubMarks(at)}), "eval")
    assert got == at[last] - at[first]
