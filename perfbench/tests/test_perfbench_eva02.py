"""EVA-02-L in the ViTDet frame in the benchmark (``configs/eva02_l_vitdet.json``):
the trunk's operation counts by hand, the reference built by name with the
program's module tree leaf for leaf and the weight recipe over every leaf,
the configuration's ``cfg`` against the shipped yaml, and the two readers of
EVA-02's trunk mark, which find nothing to read without it."""
from types import SimpleNamespace

import pytest
import torch

from perfbench.counts import model
from perfbench.counts.backbones import build_eva02_fpn_backbone as eva02
from perfbench.harness import specs
from perfbench.harness.weights import leaf_plan
from perfbench.reference.model import skeleton

CONFIG = "eva02_l_vitdet"
NAME = "build_eva02_fpn_backbone"


def test_eva02_blocks_by_hand():
    """EVA-02-L on the 832 x 1344 bucket: 52 x 84 = 4368 tokens, padded to
    64 x 96 = 6144 in 24 windows of 16 x 16 in a windowed block (block 0),
    all 4368 in a global block (block 2); SwiGLU's three projections over
    the 4368 tokens at hidden 2730."""
    cfg = specs.config(CONFIG)["cfg"]
    layers = {n: (f, t, g) for n, f, t, g in eva02.layers(cfg, 832, 1344)}
    assert layers["patch_embed"] == (4368 * 1024 * 3 * 256, True, False)
    assert layers["block0.qkv"] == (6144 * 1024 * 3072, True, True)
    assert layers["block0.attention"] == (2 * 24 * 256 * 256 * 1024, True, True)
    assert layers["block0.proj"] == (6144 * 1024 * 1024, True, True)
    assert layers["block0.mlp"] == (3 * 4368 * 1024 * 2730, True, True)
    assert layers["block2.qkv"] == (4368 * 1024 * 3072, True, True)
    assert layers["block2.attention"] == (2 * 4368 * 4368 * 1024, True, True)
    assert layers["block2.proj"] == (4368 * 1024 * 1024, True, True)
    assert layers["block2.mlp"] == layers["block0.mlp"]
    assert layers["up2a"] == (4368 * 1024 * 512 * 4, True, True)
    assert layers["p2_conv2"] == (16 * 4368 * 256 * 256 * 9, True, True)
    assert len(layers) == 1 + 4 * 24 + 2 + 8
    globals_ = [i for i in range(24) if layers[f"block{i}.qkv"][0] == 4368 * 1024 * 3072]
    assert globals_ == [2, 5, 8, 11, 14, 17, 20, 23]


def test_configuration_counts():
    """~1806 GMAC (3.61 TFLOP) a trunk, a fifth of it in attention's
    products; the size keys are read; a batch counts eight images."""
    cfg = specs.config(CONFIG)["cfg"]
    h, w = cfg["TPU"]["TEST_BUCKET"]
    trunk = [layer for layer in eva02.layers(cfg, h, w) if layer[0].startswith(("block", "patch"))]
    total = sum(f for _, f, _, _ in trunk)
    assert total == 1805634502656
    attention = sum(f for n, f, _, _ in trunk if n.endswith(".attention"))
    assert 0.19 < attention / total < 0.21
    small = {**cfg, "MODEL": {**cfg["MODEL"], "EVA02": {**cfg["MODEL"]["EVA02"], "EMBED_DIM": 64, "DEPTH": 6,
                                                         "MLP_HIDDEN": 170, "WINDOW_SIZE": 4,
                                                         "GLOBAL_BLOCKS": [2, 5]}}}
    assert eva02.layers(small, 88, 120) == eva02.eva02_pyramid(88, 120, 64, 6, 170, 4, [2, 5])
    assert model.eval_flops(cfg, (h, w), 8) == 8 * model.eval_flops(cfg, (h, w), 1)


def test_reference_builds_by_name_with_the_programs_leaves():
    """The reference's trunk found by ``MODEL.BACKBONE.NAME`` (no FPN), and
    its detector at EVA-02-L's widths (meta device) with the program's
    state-dict leaves, in order, with the program's shapes; the weight
    recipe covers every one: q and v biases truncated normal at 0.02, the
    SwiGLU projections lecun at their fan-in, the sub-LN at identity."""
    from openset_rcnn_tpu_torch.config import get_default_cfg
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, OpensetRCNN
    from perfbench.reference.model import Cfg

    config = specs.config(CONFIG)
    with torch.device("meta"):
        trunk, fpn_in = specs.backbone("reference", NAME).build(Cfg(config["cfg"]), torch.float32)
    assert fpn_in is None and trunk.depth == 24
    ref = skeleton(config["cfg"])
    cfg = get_default_cfg()
    cfg.merge_from_other(config["cfg"])
    with torch.device("meta"):
        prog = OpensetRCNN(ModelSpec.from_cfg(cfg))
    want = [(k, tuple(v.shape)) for k, v in prog.state_dict().items()]
    assert [(k, tuple(v.shape)) for k, v in ref.state_dict().items()] == want
    assert ("backbone.block0.attn.qkv.weight", (3072, 1024)) in want
    assert ("backbone.block23.mlp.w3.weight", (1024, 2730)) in want
    assert ("backbone.pos_embed", (16, 16, 1024)) in want
    assert not any(k.startswith("fpn.") for k, _ in want)
    plan = {name: (dist, scale) for name, _, dist, scale, _ in leaf_plan(ref, config["weights"]["rules"])}
    biases = [k for k in plan if k.endswith(("attn.q_bias", "attn.v_bias"))]
    assert len(biases) == 48 and all(plan[k] == ("trunc_normal", 0.02) for k in biases)
    lecun = (1 / 1024) ** 0.5 / 0.87962566103423978
    assert plan["backbone.block0.mlp.w1.weight"] == ("trunc_normal", pytest.approx(lecun))
    assert plan["backbone.block0.mlp.ffn_ln.scale"] == ("const", 1.0)
    assert plan["backbone.block0.mlp.w2.bias"] == ("const", 0.0)
    assert plan["backbone.pos_embed"] == ("normal", 0.02)


def test_configuration_is_the_shipped_yaml():
    """Every key of the configuration's ``cfg`` is the shipped yaml's merged
    into the program's defaults, but for the one key ``reduced`` names."""
    from openset_rcnn_tpu_torch.config import get_default_cfg
    from perfbench.harness.specs import ROOT

    config = specs.config(CONFIG)
    cfg = get_default_cfg()
    cfg.merge_from_file(str(ROOT / config["yaml"]))
    assert config["reduced"] == ["MODEL.RPN.DELTA_BIAS_INIT"]
    assert cfg.MODEL.RPN.DELTA_BIAS_INIT == 0.0 and config["cfg"]["MODEL"]["RPN"]["DELTA_BIAS_INIT"] == 1.0
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0

    def walk(got, want, path):
        for k, v in got.items():
            assert k in want, path + k
            if isinstance(v, dict):
                walk(v, want[k], path + k + ".")
            else:
                assert v == (list(want[k]) if isinstance(want[k], tuple) else want[k]), path + k

    walk(config["cfg"], cfg, "")
    assert config["cfg"]["MODEL"]["EVA02"]["GLOBAL_BLOCKS"] == [2, 5, 8, 11, 14, 17, 20, 23]
    assert config["cfg"]["MODEL"]["BACKBONE"]["NAME"] == NAME


class StubMarks:
    """``Marks.between_ms`` over fixed device times of one batch."""

    def __init__(self, at):
        self.at = at

    def between_ms(self, first, last):
        return [self.at[last] - self.at[first]] if first in self.at and last in self.at else []


@pytest.mark.parametrize("name, first, last", [("eva_trunk_ms", "begin", "backbone.trunk"),
                                               ("eva_pyramid_ms", "backbone.trunk", "backbone")])
def test_readers(name, first, last):
    reader = specs.metric_reader(f"{name}.eval")
    assert reader.read(SimpleNamespace(per_layer_inputs={}), "eval") is None
    vit_b = {"begin": 0.0, "backbone": 260.0, "rpn": 265.0, "cascade": 290.0}
    assert reader.read(SimpleNamespace(per_layer_inputs={"marks": StubMarks(vit_b)}), "eval") is None
    at = {**vit_b, "backbone.trunk": 230.0}
    got = reader.read(SimpleNamespace(per_layer_inputs={"marks": StubMarks(at)}), "eval")
    assert got == at[last] - at[first]
