"""Reference checkpoints -> the port's ``state_dict``.

Port of ``openset_rcnn_tpu/utils/torch_weights.py``: the d2 model-zoo
ImageNet init (caffe2-format ``R-50.pkl``), trained Openset-RCNN
``model_*.pth`` checkpoints (d2 names), the official Swin and timm/ViTDet
ViT checkpoints, and the JAX package's flat ``a/b/c`` ``.npz``. Each
converter takes a path (or, for the torch formats, a dict of arrays) and the
port model (or its ``state_dict``) and returns a full ``state_dict``: the
converted tensors, the model's own values for the rest (logged), for
``model.load_state_dict``.

Layouts. The port keeps PyTorch's layouts, so where the JAX converter
transposes, this one copies:
  * conv weights (O, I, kh, kw) and linear weights (O, I) as they are;
  * the first box-head FC is the one exception: d2 flattens pooled RoIs as
    (C, 7, 7), the port pools them as (R, 7, 7, C) in JAX's order, so the
    weight's columns are permuted (the port-side form of JAX's
    ``_linear_flatten_chw``, ``torch_weights.py:38-44``);
  * the ViT pyramid's ``simfp.up2a/up2b`` are torch ``ConvTranspose2d``
    weights on both sides, copied without the spatial flip that JAX's
    ``_deconv`` (``:279-287``) applies for flax;
  * FrozenBN ``weight/bias/running_mean/running_var`` -> the port's
    ``scale/bias/mean/var`` buffers; caffe2 files keep only the fused scale
    and bias, so their running statistics are the identity (0 and 1);
  * LayerNorm ``weight/bias`` -> ``scale/bias``.
Unmatched source keys are ignored, targets the source lacks keep the model's
values, and a shape mismatch raises, all as in JAX.
"""
from __future__ import annotations

import logging
import pickle
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from .jax_params import _convert

logger = logging.getLogger(__name__)

Source = Union[str, Mapping[str, Any]]
Target = Union[nn.Module, Mapping[str, torch.Tensor]]

STAGE_BLOCKS = {"res2": 3, "res3": 4, "res4": 6, "res5": 3}
SWIN_DEPTHS = {"T": (2, 2, 6, 2), "S": (2, 2, 18, 2), "B": (2, 2, 18, 2)}


def _load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """The arrays of a ``.pkl`` (pickle, latin1: caffe2 and d2 model-zoo
    files) or ``.pth`` (``torch.load``) file, its ``"model"`` entry if it has
    one. As the JAX package, ``torch.load`` unpickles with
    ``weights_only=False``: a checkpoint is trusted as a ``.pkl`` is."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        model = data.get("model", data)
        return {k: np.asarray(v) for k, v in model.items() if isinstance(v, np.ndarray)}
    data = torch.load(path, map_location="cpu", weights_only=False)
    model = data.get("model", data)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in model.items()}


def _source(path_or_dict: Source) -> Dict[str, np.ndarray]:
    if isinstance(path_or_dict, str):
        return _load_torch_file(path_or_dict)
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in path_or_dict.items()}


def _caffe2_to_d2_names(src: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rename caffe2 ImageNet-pkl keys into d2 ``backbone.bottom_up.*`` names
    (copy of ``openset_rcnn_tpu/utils/torch_weights.py:75-108``)."""
    out = {}
    branch_map = {"branch2a": "conv1", "branch2b": "conv2", "branch2c": "conv3", "branch1": "shortcut"}
    for k, v in src.items():
        if k == "conv1_w":
            out["backbone.bottom_up.stem.conv1.weight"] = v
        elif k in ("res_conv1_bn_s", "conv1_bn_s"):
            out["backbone.bottom_up.stem.conv1.norm.weight"] = v
        elif k in ("res_conv1_bn_b", "conv1_bn_b"):
            out["backbone.bottom_up.stem.conv1.norm.bias"] = v
        elif k.startswith("res") and ("branch" in k):
            # e.g. res2_0_branch2a_w  /  res2_0_branch2a_bn_s
            parts = k.split("_")
            stage, block, branch = parts[0], parts[1], parts[2]
            suffix = "_".join(parts[3:])
            conv = branch_map.get(branch)
            if conv is None:
                continue
            base = f"backbone.bottom_up.{stage}.{block}.{conv}"
            if suffix == "w":
                out[f"{base}.weight"] = v
            elif suffix == "bn_s":
                out[f"{base}.norm.weight"] = v
            elif suffix == "bn_b":
                out[f"{base}.norm.bias"] = v
    # caffe2 has fused stats: provide identity running stats
    for k in list(out.keys()):
        if k.endswith(".norm.weight"):
            base = k[: -len(".weight")]
            out.setdefault(f"{base}.running_mean", np.zeros_like(out[k]))
            out.setdefault(f"{base}.running_var", np.ones_like(out[k]))
    return out


class _Converted:
    """The target ``state_dict`` being filled: ``put`` checks each key and
    shape against the model's and casts to its dtype; ``missing`` collects
    the source groups the checkpoint lacks."""

    def __init__(self, src: Dict[str, np.ndarray], target: Target, prefix: str = ""):
        self.src = src
        self.state = dict(target.state_dict() if isinstance(target, nn.Module) else target)
        self.prefix = prefix
        self.loaded: List[str] = []
        self.missing: List[str] = []

    def put(self, key: str, value) -> None:
        key = self.prefix + key
        tmpl = self.state[key]
        value = np.asarray(value)
        if tuple(value.shape) != tuple(tmpl.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} != {tuple(tmpl.shape)}")
        self.state[key] = torch.from_numpy(np.array(value, order="C")).to(tmpl.dtype)
        self.loaded.append(key)

    def weight(self, name: str, dst: str, bias: bool = True) -> None:
        """A conv or linear layer: torch's layout is the port's."""
        if f"{name}.weight" not in self.src:
            self.missing.append(name)
            return
        self.put(f"{dst}.weight", self.src[f"{name}.weight"])
        if bias and f"{name}.bias" in self.src:
            self.put(f"{dst}.bias", self.src[f"{name}.bias"])

    def frozen_bn(self, prefix: str, dst: str) -> None:
        """d2's FrozenBN (``<prefix>.norm.*``) -> scale/bias/mean/var."""
        if f"{prefix}.norm.weight" not in self.src:
            self.missing.append(prefix + ".norm")
            return
        for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var")):
            self.put(f"{dst}.{ours}", self.src[f"{prefix}.norm.{theirs}"])

    def layer_norm(self, name: str, dst: str) -> None:
        if f"{name}.weight" not in self.src:
            self.missing.append(name)
            return
        self.put(f"{dst}.scale", self.src[f"{name}.weight"])
        self.put(f"{dst}.bias", self.src[f"{name}.bias"])

    def done(self, what: str, path_or_dict: Source) -> Dict[str, torch.Tensor]:
        logger.info("Converted %d %s tensors from %s (%d source groups unmatched)", len(self.loaded), what,
                    path_or_dict if isinstance(path_or_dict, str) else "<dict>", len(self.missing))
        if self.missing:
            logger.debug("unmatched: %s", self.missing)
        return self.state


def _linear_flatten_chw(w: np.ndarray, channels: int, res: int) -> np.ndarray:
    """d2's fc1 weight (O, C*res*res), columns flattened (C, res, res) ->
    the port's (O, res*res*C), columns flattened (res, res, C)."""
    out = w.shape[0]
    return w.reshape(out, channels, res, res).transpose(0, 2, 3, 1).reshape(out, res * res * channels)


def convert_torch_checkpoint(path_or_dict: Source, model: Target) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (d2 names) or a caffe2 ImageNet pkl -> the
    port's ``state_dict`` for the R50-FPN ``model``. Missing entries keep
    the model's values (logged)."""
    src = _source(path_or_dict)
    if not any(k.startswith("backbone.") for k in src):
        src = _caffe2_to_d2_names(src)
    t = _Converted(src, model)

    bu = "backbone.bottom_up"
    t.weight(f"{bu}.stem.conv1", "backbone.stem_conv", bias=False)
    t.frozen_bn(f"{bu}.stem.conv1", "backbone.stem_bn")
    for stage, nblocks in STAGE_BLOCKS.items():
        for b in range(nblocks):
            dst = f"backbone.{stage}_block{b}"
            for ci in (1, 2, 3):
                t.weight(f"{bu}.{stage}.{b}.conv{ci}", f"{dst}.conv{ci}", bias=False)
                t.frozen_bn(f"{bu}.{stage}.{b}.conv{ci}", f"{dst}.bn{ci}")
            if f"{bu}.{stage}.{b}.shortcut.weight" in src:
                t.weight(f"{bu}.{stage}.{b}.shortcut", f"{dst}.shortcut", bias=False)
                t.frozen_bn(f"{bu}.{stage}.{b}.shortcut", f"{dst}.shortcut_bn")

    for lvl in (2, 3, 4, 5):
        t.weight(f"backbone.fpn_lateral{lvl}", f"fpn.lateral_res{lvl}")
        t.weight(f"backbone.fpn_output{lvl}", f"fpn.output_res{lvl}")

    for name in ("conv", "anchor_deltas", "centerness"):
        t.weight(f"proposal_generator.rpn_head.{name}", f"rpn_head.{name}")

    if "roi_heads.box_head.fc1.weight" in src:
        t.put("box_head.fc1.weight", _linear_flatten_chw(src["roi_heads.box_head.fc1.weight"], channels=256, res=7))
        t.put("box_head.fc1.bias", src["roi_heads.box_head.fc1.bias"])
        t.put("box_head.fc2.weight", src["roi_heads.box_head.fc2.weight"])
        t.put("box_head.fc2.bias", src["roi_heads.box_head.fc2.bias"])
    for name, dst in (
        ("roi_heads.box_predictor.bbox_pred", "box_predictor.bbox_pred"),
        ("roi_heads.box_predictor.iou_pred", "box_predictor.iou_pred"),
        ("roi_heads.dml.encoder", "pln.encoder"),
        ("roi_heads.dml.decoder", "pln.decoder"),
        ("roi_heads.softmaxcls.cls_score", "classifier.cls_score"),
    ):
        t.weight(name, dst)
    if "roi_heads.dml.representatives" in src:
        t.put("pln.representatives", src["roi_heads.dml.representatives"])
    return t.done("d2", path_or_dict)


# port R50-FPN name -> d2 name, for ``to_d2`` (the converter's map, inverted)
_D2_NAMES = (
    (r"^backbone\.stem_conv\.", "backbone.bottom_up.stem.conv1."),
    (r"^backbone\.stem_bn\.", "backbone.bottom_up.stem.conv1.norm."),
    (r"^backbone\.(res\d)_block(\d+)\.bn(\d)\.", r"backbone.bottom_up.\1.\2.conv\3.norm."),
    (r"^backbone\.(res\d)_block(\d+)\.shortcut_bn\.", r"backbone.bottom_up.\1.\2.shortcut.norm."),
    (r"^backbone\.(res\d)_block(\d+)\.", r"backbone.bottom_up.\1.\2."),
    (r"^fpn\.lateral_res(\d)\.", r"backbone.fpn_lateral\1."),
    (r"^fpn\.output_res(\d)\.", r"backbone.fpn_output\1."),
    (r"^rpn_head\.", "proposal_generator.rpn_head."),
    (r"^(box_head|box_predictor)\.", r"roi_heads.\1."),
    (r"^pln\.", "roi_heads.dml."),
    (r"^classifier\.", "roi_heads.softmaxcls."),
    (r"\.norm\.scale$", ".norm.weight"),
    (r"\.norm\.mean$", ".norm.running_mean"),
    (r"\.norm\.var$", ".norm.running_var"),
)


def to_d2(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``convert_torch_checkpoint``: a port R50-FPN
    ``state_dict`` under d2 names and layouts (fc1's columns back in CHW
    order), e.g. to save as a ``.pth`` for the reference's tools or the JAX
    package's ``MODEL.WEIGHTS``."""
    out = {}
    for key, value in state_dict.items():
        value = value.detach().cpu().numpy()
        if key == "box_head.fc1.weight":
            o, res = value.shape[0], int(round((value.shape[1] // 256) ** 0.5))
            value = value.reshape(o, res, res, 256).transpose(0, 3, 1, 2).reshape(o, -1)
        for pattern, repl in _D2_NAMES:
            key = re.sub(pattern, repl, key)
        out[key] = np.ascontiguousarray(value)
    return out


def _backbone_prefix(target: Target, key: str) -> str:
    """"backbone." for a whole detector, "" for a bare backbone."""
    keys = target.state_dict() if isinstance(target, nn.Module) else target
    return "backbone." if f"backbone.{key}" in keys else ""


def convert_swin_torch(path_or_dict: Source, model: Target, size: str = "T",
                       depths: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
    """Official Swin ImageNet checkpoint (microsoft/Swin-Transformer names)
    -> the backbone of ``model`` (a detector or a bare ``SwinTransformer``).

    As ``openset_rcnn_tpu/utils/torch_weights.py:202-276``: the four
    output-stage LayerNorms (``out_norm{0..3}``) have no ImageNet
    counterpart and keep the model's values; the classification head and
    final norm are dropped; only the relative-position bias TABLE is
    converted (the index is recomputed by the model)."""
    src = _source(path_or_dict)
    t = _Converted(src, model, _backbone_prefix(model, "patch_embed.weight"))
    t.put("patch_embed.weight", src["patch_embed.proj.weight"])
    t.put("patch_embed.bias", src["patch_embed.proj.bias"])
    t.layer_norm("patch_embed.norm", "patch_norm")
    for s, depth in enumerate(depths or SWIN_DEPTHS[size]):
        for b in range(depth):
            theirs, ours = f"layers.{s}.blocks.{b}", f"stage{s}_block{b}"
            t.layer_norm(f"{theirs}.norm1", f"{ours}.norm1")
            t.weight(f"{theirs}.attn.qkv", f"{ours}.attn.qkv")
            t.weight(f"{theirs}.attn.proj", f"{ours}.attn.proj")
            t.put(f"{ours}.attn.rel_bias_table", src[f"{theirs}.attn.relative_position_bias_table"])
            t.layer_norm(f"{theirs}.norm2", f"{ours}.norm2")
            t.weight(f"{theirs}.mlp.fc1", f"{ours}.mlp_fc1")
            t.weight(f"{theirs}.mlp.fc2", f"{ours}.mlp_fc2")
        if s < 3:
            t.layer_norm(f"layers.{s}.downsample.norm", f"downsample{s}.norm")
            t.weight(f"layers.{s}.downsample.reduction", f"downsample{s}.reduction", bias=False)
    return t.done("Swin", path_or_dict)


def _pos_table(pos: np.ndarray, pos_grid: Tuple[int, int]) -> np.ndarray:
    """A pretrain ``pos_embed`` (1, [1+]gh*gw, C) -> the (gh, gw, C) table at
    the model's native ``pos_grid``: the class token dropped, a torch-exact
    bicubic resize in float64 when the grids differ (as JAX,
    ``torch_weights.py:366-385``)."""
    if pos.ndim == 3 and pos.shape[0] == 1:  # (1, [1+]gh*gw, C) token table
        n, c = pos.shape[1], pos.shape[2]
        g = int(np.sqrt(n))
        if g * g != n:  # leading class token
            pos = pos[:, 1:]
            g = int(np.sqrt(pos.shape[1]))
            if g * g != pos.shape[1]:
                raise ValueError(f"pos_embed length {n} is not 1+k^2")
        pos = pos.reshape(g, g, c)
    if pos.shape[:2] != tuple(pos_grid):
        from ..models.vit import bicubic_resize_matrix

        wh = bicubic_resize_matrix(pos_grid[0], pos.shape[0])
        ww = bicubic_resize_matrix(pos_grid[1], pos.shape[1])
        pos = np.einsum("hH,HWc,wW->hwc", wh, pos.astype(np.float64), ww)
    return pos


def convert_vit_torch(path_or_dict: Source, model: Target, depth: int = 12,
                      pos_grid: Tuple[int, int] = (14, 14)) -> Dict[str, torch.Tensor]:
    """ViT checkpoint (timm/MAE/ViTDet trunk names) -> the backbone of
    ``model`` (a detector or a bare ``ViTSimpleFPN``).

    As ``openset_rcnn_tpu/utils/torch_weights.py:290-405``: the trunk, the
    position table (see ``_pos_table``) and, in detection-format
    checkpoints, the simple pyramid (``simfp.*``); a pretrain-only
    checkpoint leaves the pyramid at the model's values."""
    src = _source(path_or_dict)
    t = _Converted(src, model, _backbone_prefix(model, "patch_embed.weight"))
    t.put("patch_embed.weight", src["patch_embed.proj.weight"])
    t.put("patch_embed.bias", src["patch_embed.proj.bias"])
    t.put("pos_embed", _pos_table(np.asarray(src["pos_embed"]), pos_grid))
    for i in range(depth):
        theirs, ours = f"blocks.{i}", f"block{i}"
        t.layer_norm(f"{theirs}.norm1", f"{ours}.norm1")
        t.weight(f"{theirs}.attn.qkv", f"{ours}.attn.qkv")
        t.weight(f"{theirs}.attn.proj", f"{ours}.attn.proj")
        t.layer_norm(f"{theirs}.norm2", f"{ours}.norm2")
        t.weight(f"{theirs}.mlp.fc1", f"{ours}.mlp_fc1")
        t.weight(f"{theirs}.mlp.fc2", f"{ours}.mlp_fc2")
    t.layer_norm("norm", "norm")
    if "simfp.up2a.weight" in src:
        for up in ("up2a", "up2b"):  # ConvTranspose2d on both sides: no flip
            t.weight(f"simfp.{up}", up)
        for lvl in (2, 3, 4, 5):
            for ci in (1, 2):
                t.put(f"p{lvl}_conv{ci}.weight", src[f"simfp.p{lvl}_conv{ci}.weight"])
                t.layer_norm(f"simfp.p{lvl}_ln{ci}", f"p{lvl}_ln{ci}")
    return t.done("ViT", path_or_dict)


def load_npz(path: str, model: Target) -> Dict[str, torch.Tensor]:
    """The JAX package's flat ``a/b/c``-keyed ``.npz`` of its parameter tree
    (what ``load_npz_into_params``, ``torch_weights.py:408-418``, reads) ->
    the port's ``state_dict``: each key through ``jax_params._convert``;
    keys the file lacks keep the model's values. A key with no counterpart
    in the model, or of another shape, raises."""
    state = dict(model.state_dict() if isinstance(model, nn.Module) else model)
    loaded = 0
    with np.load(path) as data:
        for name in data.files:
            key, value = _convert(name.replace("/", "."), data[name])
            if key not in state:
                raise KeyError(f"{path}: {name} maps to {key}, which the model does not have")
            if tuple(value.shape) != tuple(state[key].shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)} != {tuple(state[key].shape)}")
            state[key] = value.to(state[key].dtype)
            loaded += 1
    logger.info("Loaded %d tensors from %s (%d keep the model's values)", loaded, path, len(state) - loaded)
    return state
