"""``counts/`` against hand counts at tiny shapes, and the counts of the
benchmark's configurations pinned."""
import pytest

from perfbench.counts import model, roi_align
from perfbench.harness import specs

resnet = specs.backbone("counts", "build_resnet_fpn_backbone")
vit = specs.backbone("counts", "build_vit_fpn_backbone")

# (eval_flops at TEST_BUCKET and EVAL_BATCH_SIZE, step_flops at TRAIN_BUCKET
# and SOLVER.IMS_PER_BATCH), as the counts gave them when each trunk was
# still named in counts/model.py
PINNED = {"r50_fpn_bf16": (4256614535168.0, 18963380920320.0),
          "vitdet_b_fpn": (11144258342912.0, 15391492233216.0)}


def test_conv_output_sizes():
    assert [model.conv_out(n, 7, 2) for n in (832, 1344, 33)] == [416, 672, 17]
    assert [model.conv_out(n, 1, 2) for n in (208, 7)] == [104, 4]
    assert model.conv_out(52, 3, 1) == 52


def test_resnet_layers_by_hand():
    layers = {n: (f, t, g) for n, f, t, g in resnet.resnet_fpn(64, 64, 50, freeze_at=2)}
    # stem: 32x32 outputs, 64 filters of 3x7x7
    assert layers["stem"] == (32 * 32 * 64 * 3 * 49, False, False)
    # res2 is frozen: no weight gradient, no input gradient
    assert layers["res2_block0.conv2"] == (16 * 16 * 64 * 64 * 9, False, False)
    # res3's first block: stride 2 in its 1x1; its input comes from frozen res2
    assert layers["res3_block0.conv1"] == (8 * 8 * 128 * 256, True, False)
    assert layers["res3_block0.shortcut"] == (8 * 8 * 512 * 256, True, False)
    assert layers["res3_block0.conv2"] == (8 * 8 * 128 * 128 * 9, True, True)
    assert layers["res5_block2.conv3"] == (2 * 2 * 2048 * 512, True, True)
    assert layers["fpn.lateral_res2"] == (16 * 16 * 256 * 256, True, False)
    assert layers["fpn.lateral_res4"] == (4 * 4 * 256 * 1024, True, True)
    assert len([n for n in layers if n.startswith("res")]) == 3 * 16 + 4


def test_vit_layers_by_hand():
    layers = {n: f for n, f, _, _ in vit.vit_pyramid(64, 96, patch=16, dim=8, depth=3, window=3, global_every=3,
                                                       mlp_ratio=4, out=4)}
    n, npad = 4 * 6, 6 * 6  # a 4x6 grid; windows of 3 pad it to 6x6
    assert layers["patch_embed"] == n * 8 * 3 * 256
    assert layers["block0.qkv"] == npad * 8 * 24 and layers["block2.qkv"] == n * 8 * 24
    assert layers["block0.attention"] == 2 * 4 * 81 * 8  # 4 windows of 9 tokens
    assert layers["block2.attention"] == 2 * n * n * 8
    assert layers["block1.mlp"] == 2 * n * 8 * 32
    assert layers["up2a"] == n * 8 * 4 * 4 and layers["p5_conv1"] == 2 * 3 * 4 * 8


def test_resnet_depth_is_read_from_the_configuration():
    cfg = specs.config("r50_fpn_bf16")["cfg"]
    deeper = {**cfg, "MODEL": {**cfg["MODEL"], "RESNETS": {**cfg["MODEL"]["RESNETS"], "DEPTH": 101}}}
    names = [n for n, _, _, _ in resnet.layers(deeper, 64, 64)]
    assert "res4_block22.conv3" in names and "res4_block23.conv1" not in names
    assert model.eval_flops(deeper, (64, 64), 1) > model.eval_flops(cfg, (64, 64), 1)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_configuration_counts_are_pinned(name):
    cfg = specs.config(name)["cfg"]
    t = cfg["TPU"]
    got = (model.eval_flops(cfg, tuple(t["TEST_BUCKET"]), t["EVAL_BATCH_SIZE"]),
           model.step_flops(cfg, tuple(t["TRAIN_BUCKET"]), cfg["SOLVER"]["IMS_PER_BATCH"]))
    assert got == PINNED[name]


def test_train_counts_every_layer_once_forward_and_as_needed_backward():
    cfg = specs.config("r50_fpn_bf16")["cfg"]
    fwd = model.forward_flops(cfg, (64, 64), 2, 8)
    train = model.train_flops(cfg, (64, 64), 2, 8)
    by_hand = sum(2 * f * (1 + t + g) for _, f, t, g in model.layers(cfg, (64, 64), 2, 8))
    assert train == by_hand and fwd < train < 3 * fwd


def test_proposals_and_roi_align_bytes():
    assert model.proposals_per_image(832, 1344, 1000) == 4 * 1000 + 13 * 21
    assert roi_align.level_hw((832, 1344)) == [(208, 336), (104, 168), (52, 84), (26, 42)]
    cells = 208 * 336 + 104 * 168 + 52 * 84 + 26 * 42
    assert roi_align.fwd_bytes(8, 4273, (832, 1344)) == 8 * cells * 256 * 2 + 8 * 4273 * 49 * 256 * 4 + 8 * 4273 * 20
    assert roi_align.bwd_bytes(16, 512, (832, 1344), "pallas_bf16") == (16 * 512 * 49 * 256 * 4 + 16 * cells * 256 * 2
                                                                       + 16 * 512 * 20)
    assert roi_align.bound_s(3.35e12) == pytest.approx(1.0)
