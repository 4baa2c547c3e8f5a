"""The port's weight converters (``openset_rcnn_tpu_torch/utils/torch_weights.py``)
and ``MODEL.WEIGHTS`` loading against the JAX package, on the CPU.

Every check is bitwise: the port's state_dict must equal JAX's converter
(``openset_rcnn_tpu/utils/torch_weights.py``) followed by
``utils/jax_params.state_dict_from_jax``, on

* the full-width R50-FPN of ``openset_rcnn_R50_FPN_128k_tpu.yaml`` from a
  d2 ``.pth`` (with the optimizer, scheduler and iteration entries of a d2
  checkpoint), a d2 ``.pkl``, a caffe2 ImageNet ``.pkl`` (backbone only,
  identity running statistics, an unused ``fc1000`` entry) and the JAX
  package's flat ``.npz``; the fc1 column permutation and the transposes
  show up here, since JAX's side transposes and ``jax_params`` transposes
  back;
* the full-width Swin-T and ViT-B backbones from synthetic official / timm
  state dicts with the real key names and shapes: the ViT's ``pos_embed``
  carries a class token and a 16x16 grid resized to the 14x14 table, and the
  ``simfp`` transposed convolutions go through JAX's flip and
  ``jax_params``' flip back;
* partial sources (the rest keeps the port model's values) and shape
  mismatches (raise); and the meaning of the fc1 permutation: a d2 box head
  on CHW-flattened RoIs equals the port's ``fc1`` on the same RoIs pooled
  HWC within 1e-5.

JAX's templates are zero trees of ``jax.eval_shape`` (the converters read
only their shapes and dtypes), so no JAX init is compiled.
"""
import pickle
import re
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openset_rcnn_tpu.config import get_default_cfg as jax_default_cfg
from openset_rcnn_tpu.engine.train_loop import build_model_spec
from openset_rcnn_tpu.models import OpensetRCNNModule
from openset_rcnn_tpu.utils import torch_weights as jax_tw
from openset_rcnn_tpu_torch.config import get_default_cfg as port_default_cfg
from openset_rcnn_tpu_torch.engine.checkpoint import load_weights_file
from openset_rcnn_tpu_torch.models.detector import ModelSpec, OpensetRCNN
from openset_rcnn_tpu_torch.utils import torch_weights as port_tw
from openset_rcnn_tpu_torch.utils.jax_params import _flatten, state_dict_from_jax
from tests.port_threads import share_cores  # noqa: F401 (autouse)
from tests.test_torch_converter import build_torch_dict

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {
    "r50": ROOT / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml",
    "swin": ROOT / "configs/VOC-COCO/openset_rcnn_SwinT_FPN_128k.yaml",
    "vit": ROOT / "configs/VOC-COCO/openset_rcnn_ViT_FPN_128k.yaml",
}


def jax_template(config):
    """Zero numpy tree of the JAX detector's params for ``config`` (a config
    file, or a JAX CfgNode)."""
    cfg = config
    if isinstance(config, Path):
        cfg = jax_default_cfg()
        cfg.merge_from_file(str(config))
    module = OpensetRCNNModule(spec=build_model_spec(cfg))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"])
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def port_model(config):
    cfg = port_default_cfg()
    cfg.merge_from_file(str(config))
    model = OpensetRCNN(ModelSpec.from_cfg(cfg))
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


@pytest.fixture(scope="module")
def r50():
    template = jax_template(CONFIGS["r50"])
    return template, port_model(CONFIGS["r50"])


def jax_state(params, model):
    """JAX params -> the port's naming and layout."""
    return state_dict_from_jax(flax.serialization.to_state_dict(params), model.state_dict().keys())


def assert_state_equal(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    assert keys
    for k in keys:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def caffe2_names(d2):
    """The caffe2 ImageNet-pkl names of a d2 dict's backbone (the inverse of
    ``_caffe2_to_d2_names``), fused BN only, plus the classifier caffe2
    files carry."""
    out = {"fc1000_w": np.ones((1000, 2048), np.float32), "fc1000_b": np.zeros(1000, np.float32)}
    branch = {"conv1": "branch2a", "conv2": "branch2b", "conv3": "branch2c", "shortcut": "branch1"}
    for k, v in d2.items():
        m = re.fullmatch(r"backbone\.bottom_up\.(res\d)\.(\d+)\.(\w+?)\.(weight|norm\.weight|norm\.bias)", k)
        suffix = {"weight": "w", "norm.weight": "bn_s", "norm.bias": "bn_b"}
        if m:
            out[f"{m[1]}_{m[2]}_{branch[m[3]]}_{suffix[m[4]]}"] = v
        elif k == "backbone.bottom_up.stem.conv1.weight":
            out["conv1_w"] = v
        elif k.startswith("backbone.bottom_up.stem.conv1.norm.") and not k.endswith(("_mean", "_var")):
            out["res_conv1_bn_" + ("s" if k.endswith("weight") else "b")] = v
    return out


def write_source(kind, d2, path):
    """The d2 dict ``d2`` as a ``kind`` file; returns its path."""
    if kind == "pth":  # a d2 checkpoint: model, optimizer, scheduler, iteration
        path = path / "model_final.pth"
        torch.save({"model": {k: torch.from_numpy(v) for k, v in d2.items()},
                    "optimizer": {"state": {}, "param_groups": [{"lr": 0.02, "momentum": 0.9, "params": [0, 1]}]},
                    "scheduler": {"base_lrs": [0.02], "last_epoch": 5, "milestones": {100: 1}},
                    "iteration": 5}, path)
    else:
        path = path / ("R-50.pkl" if kind == "caffe2_pkl" else "model_final.pkl")
        with open(path, "wb") as f:
            pickle.dump({"model": caffe2_names(d2) if kind == "caffe2_pkl" else d2}, f)
    return str(path)


def write_npz(params, path):
    """The JAX package's flat 'a/b/c' .npz of ``params`` (what its
    ``load_npz_into_params`` reads)."""
    flat = {k.replace(".", "/"): v for k, v in _flatten(flax.serialization.to_state_dict(params)).items()}
    np.savez(path, **flat)
    return str(path)


def random_params(template, rng):
    return jax.tree.map(lambda t: rng.standard_normal(t.shape).astype(t.dtype), template)


@pytest.mark.parametrize("kind", ["pth", "pkl", "caffe2_pkl", "npz"])
def test_r50_formats_match_jax(r50, tmp_path, kind):
    template, model = r50
    rng = np.random.RandomState(0)
    if kind == "npz":
        path = write_npz(random_params(template, rng), tmp_path / "weights.npz")
        want = jax_state(jax_tw.load_npz_into_params(path, template), model)
        got = port_tw.load_npz(path, model)
    else:
        path = write_source(kind, build_torch_dict(template, rng), tmp_path)
        want = jax_state(jax_tw.convert_torch_checkpoint(path, template), model)
        got = port_tw.convert_torch_checkpoint(path, model)
    assert set(got) == set(model.state_dict())
    if kind == "caffe2_pkl":
        # the backbone alone; the rest keeps the port model's values
        keys = [k for k in want if k.startswith("backbone.")]
        assert_state_equal(got, want, keys)
        assert all(torch.equal(got[k], v) for k, v in model.state_dict().items() if not k.startswith("backbone."))
        assert torch.equal(got["backbone.res3_block0.bn2.var"], torch.ones(128))
    else:
        assert_state_equal(got, want)
    # MODEL.WEIGHTS takes the same route
    loaded = port_model(CONFIGS["r50"])
    load_weights_file(path, loaded)
    assert_state_equal(loaded.state_dict(), got)


def swin_source(model, rng):
    """Official Swin-T names and shapes, from the port backbone's keys (the
    out-stage norms have no ImageNet counterpart), plus the entries the
    converter ignores."""
    rename = [(r"^patch_embed\.(weight|bias)$", r"patch_embed.proj.\1"), (r"^patch_norm\.", "patch_embed.norm."),
              (r"^stage(\d)_block(\d+)\.", r"layers.\1.blocks.\2."), (r"^downsample(\d)\.", r"layers.\1.downsample."),
              (r"attn\.rel_bias_table$", "attn.relative_position_bias_table"), (r"mlp_fc", "mlp.fc"),
              (r"\.scale$", ".weight")]
    src = {"norm.weight": rng.standard_normal(768), "head.weight": rng.standard_normal((1000, 768)),
           "layers.0.blocks.0.attn.relative_position_index": np.zeros((49, 49), np.int64)}
    for k, v in model.backbone.state_dict().items():
        if k.startswith("out_norm"):
            continue
        for pattern, repl in rename:
            k = re.sub(pattern, repl, k)
        src[k] = rng.standard_normal(tuple(v.shape)).astype(np.float32)
    return src


def vit_source(model, rng):
    """timm/ViTDet ViT-B names and shapes with the simple pyramid: a class
    token and a 16x16 position grid (resized to the 14x14 table)."""
    rename = [(r"^patch_embed\.", "patch_embed.proj."), (r"^block(\d+)\.", r"blocks.\1."), (r"mlp_fc", "mlp.fc"),
              (r"^(up2a|up2b|p\d_conv\d|p\d_ln\d)\.", r"simfp.\1."), (r"\.scale$", ".weight"),
]
    src = {"cls_token": rng.standard_normal((1, 1, 768)).astype(np.float32),
           "pos_embed": rng.standard_normal((1, 1 + 16 * 16, 768)).astype(np.float32)}
    for k, v in model.backbone.state_dict().items():
        if k == "pos_embed":
            continue
        for pattern, repl in rename:
            k = re.sub(pattern, repl, k)
        src[k] = rng.standard_normal(tuple(v.shape)).astype(np.float32)
    return src


@pytest.mark.parametrize("backbone", ["swin", "vit"])
def test_transformer_converters_match_jax(backbone):
    template, model = jax_template(CONFIGS[backbone]), port_model(CONFIGS[backbone])
    rng = np.random.RandomState(1)
    if backbone == "swin":
        src = swin_source(model, rng)
        want = jax_tw.convert_swin_torch(src, template, size="T")
        got = port_tw.convert_swin_torch({k: torch.from_numpy(np.asarray(v)) for k, v in src.items()}, model)
        new = [k for k in got if k.startswith("backbone.out_norm")]  # no ImageNet counterpart
        assert len(new) == 8
    else:
        src = vit_source(model, rng)
        assert src["simfp.up2a.weight"].shape == (768, 384, 2, 2)  # torch ConvTranspose2d (I, O, kh, kw)
        want = jax_tw.convert_vit_torch(src, template)
        got = port_tw.convert_vit_torch(src, model)
        new = []
    want = jax_state(want, model)
    keys = [k for k in got if k.startswith("backbone.") and k not in new]
    assert len(keys) == len(model.backbone.state_dict()) - len(new)
    assert_state_equal(got, want, keys)
    for k in new:
        assert torch.equal(got[k], model.state_dict()[k]), k
    if backbone == "vit":
        assert tuple(got["backbone.pos_embed"].shape) == (14, 14, 768)
        # the port copies the transposed convolutions as torch stores them
        assert torch.equal(got["backbone.up2a.weight"], torch.from_numpy(src["simfp.up2a.weight"]))


def test_partial_sources_keep_the_models_values(r50, tmp_path):
    template, model = r50
    rng = np.random.RandomState(2)
    d2 = {k: v for k, v in build_torch_dict(template, rng).items() if not k.startswith(("roi_heads.", "backbone.fpn"))}
    got = port_tw.convert_torch_checkpoint(d2, model)
    want = jax_state(jax_tw.convert_torch_checkpoint(write_source("pkl", d2, tmp_path), template), model)
    init = model.state_dict()
    moved = [k for k in got if not torch.equal(got[k], init[k])]
    assert moved and all(k.startswith(("backbone.", "rpn_head.")) for k in moved)
    assert_state_equal(got, want, [k for k in got if k.startswith(("backbone.", "rpn_head."))])
    for k in got:
        if k.startswith(("fpn.", "box_head.", "box_predictor.", "pln.", "classifier.")):
            assert torch.equal(got[k], init[k]), k

    flat = {k.replace(".", "/"): v for k, v in _flatten(flax.serialization.to_state_dict(
        random_params(template, rng))).items() if k.startswith("rpn_head.")}
    np.savez(tmp_path / "part.npz", **flat)
    got = port_tw.load_npz(str(tmp_path / "part.npz"), model)
    assert {k for k in got if not torch.equal(got[k], init[k])} == {k for k in init if k.startswith("rpn_head.")}


@pytest.mark.parametrize("kind", ["d2", "npz"])
def test_shape_mismatch_raises(r50, tmp_path, kind):
    template, model = r50
    if kind == "d2":
        d2 = {"backbone.bottom_up.stem.conv1.weight": np.zeros((64, 3, 5, 5), np.float32)}
        with pytest.raises(ValueError, match="stem_conv"):
            jax_tw.convert_torch_checkpoint(write_source("pkl", d2, tmp_path), template)
        with pytest.raises(ValueError, match="backbone.stem_conv.weight: shape"):
            port_tw.convert_torch_checkpoint(d2, model)
    else:
        np.savez(tmp_path / "bad.npz", **{"rpn_head/conv/kernel": np.zeros((3, 3, 256, 128), np.float32)})
        with pytest.raises(ValueError, match="rpn_head.conv.weight: shape"):
            port_tw.load_npz(str(tmp_path / "bad.npz"), model)


def test_fc1_permutation_means_chw_to_hwc(r50):
    """A d2 box head on CHW-flattened RoIs equals the port's fc1 (the
    converted weight) on the same RoIs pooled HWC, as the port pools them."""
    _, model = r50
    rng = np.random.RandomState(3)
    w = rng.standard_normal((1024, 256 * 7 * 7)).astype(np.float32) * 0.01
    b = rng.standard_normal(1024).astype(np.float32)
    # a d2 source names at least one backbone.* key (else it is read as caffe2)
    stem = model.state_dict()["backbone.stem_conv.weight"].numpy()
    state = port_tw.convert_torch_checkpoint(
        {"backbone.bottom_up.stem.conv1.weight": stem,
         "roi_heads.box_head.fc1.weight": w, "roi_heads.box_head.fc1.bias": b,
         "roi_heads.box_head.fc2.weight": np.zeros((1024, 1024), np.float32),
         "roi_heads.box_head.fc2.bias": np.zeros(1024, np.float32)}, model)
    assert torch.equal(state["box_head.fc1.bias"], torch.from_numpy(b))
    pooled = torch.from_numpy(rng.standard_normal((5, 7, 7, 256)).astype(np.float32))  # (R, 7, 7, C)
    d2 = torch.nn.functional.linear(pooled.permute(0, 3, 1, 2).reshape(5, -1), torch.from_numpy(w), torch.from_numpy(b))
    fc1 = torch.nn.Linear(256 * 7 * 7, 1024)
    fc1.load_state_dict({"weight": state["box_head.fc1.weight"], "bias": state["box_head.fc1.bias"]})
    port = fc1(pooled.reshape(5, -1))
    torch.testing.assert_close(port, d2, rtol=0, atol=1e-5)


def test_to_d2_round_trips_through_both_converters(r50, tmp_path):
    """``to_d2`` (port -> d2 names and layouts) is the converter's inverse:
    the port's and JAX's converters both read its ``.pth`` back to the port
    model's weights, bitwise."""
    template, model = r50
    path = tmp_path / "port.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in port_tw.to_d2(model.state_dict()).items()}}, path)
    fresh = port_model(CONFIGS["r50"])
    fresh.reset_parameters(torch.Generator().manual_seed(5))
    assert_state_equal(port_tw.convert_torch_checkpoint(str(path), fresh), model.state_dict())
    assert_state_equal(jax_state(jax_tw.convert_torch_checkpoint(str(path), template), model), model.state_dict())
