"""OpensetRCNN: the two-stage open-set detector, inference forward.

Port of ``openset_rcnn_tpu/models/detector.py:48-316, 319-324, 469-499``:
``ModelSpec.from_cfg``, the module holding every parameter, anchors per image
bucket, and ``inference_forward`` (preprocess -> backbone + FPN -> CF-RPN ->
proposals -> RoIAlign -> heads -> ``RawDetections``).

Layout: images enter as (B, H, W, 3) raw BGR pixels, the JAX layout; the
trunk runs NCHW in ``channels_last`` memory, so on the GPU the FPN maps are
NHWC-contiguous for the RoIAlign kernel.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.anchors import fpn_anchors
from ..ops.box_transforms import Box2BoxTransform, Box2BoxTransformLinear
from ..structures import RawDetections
from .fpn import FPN
from .resnet import ResNet
from .roi_heads import BoxHead, BoxIouPredictor, KnownClassifier, PLNHead, pool_features, raw_detections
from .rpn import ClsFreeRPNHead, select_proposals

RPN_STRIDES = (4, 8, 16, 32, 64)
ROI_STRIDES = (4, 8, 16, 32)


class ModelSpec(NamedTuple):
    """Static hyperparameters distilled from a CfgNode: the fields of the JAX
    ModelSpec that the serving path reads, under the same names. Training
    fields join with the training slice."""

    num_known_classes: int
    pixel_mean: Tuple[float, ...]
    pixel_std: Tuple[float, ...]
    anchor_sizes: Tuple[Tuple[float, ...], ...]
    anchor_aspect_ratios: Tuple[float, ...]
    pre_nms_topk_test: int
    min_box_size: float
    fc_dim: int
    pooler_resolution: int
    roi_sampling_ratio: int
    bbox_reg_weights: Tuple[float, ...]
    mean_type: str
    emd_dim: int
    distance_type: str
    reps_per_class: int
    compute_dtype: str
    backbone_name: str
    rpn_delta_bias_init: float
    resnet_depth: int

    @staticmethod
    def from_cfg(cfg) -> "ModelSpec":
        m = cfg.MODEL
        return ModelSpec(
            num_known_classes=m.ROI_HEADS.NUM_KNOWN_CLASSES,
            pixel_mean=tuple(m.PIXEL_MEAN),
            pixel_std=tuple(m.PIXEL_STD),
            anchor_sizes=tuple(tuple(s) for s in m.ANCHOR_GENERATOR.SIZES),
            anchor_aspect_ratios=tuple(m.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
            pre_nms_topk_test=m.RPN.PRE_NMS_TOPK_TEST,
            min_box_size=float(m.PROPOSAL_GENERATOR.MIN_SIZE),
            fc_dim=m.ROI_BOX_HEAD.FC_DIM,
            pooler_resolution=m.ROI_BOX_HEAD.POOLER_RESOLUTION,
            roi_sampling_ratio=cfg.TPU.ROI_SAMPLING_RATIO,
            bbox_reg_weights=tuple(m.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
            mean_type=m.ROI_HEADS.MEAN_TYPE,
            emd_dim=m.PLN.EMD_DIM,
            distance_type=m.PLN.DISTANCE_TYPE,
            reps_per_class=m.PLN.REPS_PER_CLASS,
            compute_dtype=cfg.TPU.DTYPE,
            backbone_name=m.BACKBONE.NAME,
            rpn_delta_bias_init=m.RPN.get("DELTA_BIAS_INIT", 0.0),
            resnet_depth=m.RESNETS.DEPTH,
        )


class OpensetRCNN(nn.Module):
    """Every parameter of the detector; the functions below do the rest.

    The port runs the R50-FPN trunk in float32 with the static RoIAlign grid;
    the bf16 trunk, the adaptive grid and the Swin/ViT backbones are later
    slices and raise here.
    """

    def __init__(self, spec: ModelSpec):
        super().__init__()
        if spec.backbone_name != "build_resnet_fpn_backbone":
            raise NotImplementedError(f"backbone {spec.backbone_name} is not ported yet")
        if spec.compute_dtype != "float32":
            raise NotImplementedError(f"compute dtype {spec.compute_dtype} is not ported yet")
        if spec.roi_sampling_ratio < 1:
            raise NotImplementedError("the adaptive RoIAlign grid (ROI_SAMPLING_RATIO -1) is not ported yet")
        self.spec = spec
        num_anchors = len(spec.anchor_aspect_ratios) * len(spec.anchor_sizes[0])
        self.backbone = ResNet(depth=spec.resnet_depth)
        self.fpn = FPN(out_channels=256)
        self.rpn_head = ClsFreeRPNHead(256, num_anchors, spec.rpn_delta_bias_init)
        self.box_head = BoxHead(in_dim=256 * spec.pooler_resolution**2, fc_dim=spec.fc_dim)
        self.box_predictor = BoxIouPredictor(spec.fc_dim)
        self.pln = PLNHead(spec.fc_dim, spec.emd_dim, spec.num_known_classes, spec.reps_per_class)
        self.classifier = KnownClassifier(spec.fc_dim, spec.num_known_classes)
        self.register_buffer("pixel_mean", torch.tensor(spec.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(spec.pixel_std, dtype=torch.float32), persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX module's initializers, drawn from ``generator``."""
        for m in (self.backbone, self.fpn, self.rpn_head, self.box_head,
                  self.box_predictor, self.pln, self.classifier):
            m.reset_parameters(generator)

    def preprocess(self, images: torch.Tensor, image_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, W, 3) raw pixels -> normalised NCHW (channels_last memory).

        d2 normalises first and then pads with 0.0, so the pad region is
        exactly 0.0; the loader pads raw pixels with 0, so the pad region is
        masked back to 0.0 here.
        """
        x = (images.float() - self.pixel_mean) / self.pixel_std
        if image_hw is not None:
            H, W = images.shape[1:3]
            ys = torch.arange(H, dtype=torch.float32, device=x.device)[None, :, None]
            xs = torch.arange(W, dtype=torch.float32, device=x.device)[None, None, :]
            m = (ys < image_hw[:, 0, None, None]) & (xs < image_hw[:, 1, None, None])
            x = torch.where(m[..., None], x, torch.zeros_like(x))
        return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    def features(self, images: torch.Tensor, image_hw: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        return self.fpn(self.backbone(self.preprocess(images, image_hw)))

    def rpn_predictions(self, fpn_feats: Dict[str, torch.Tensor],
                        in_features: Sequence[str] = ("p2", "p3", "p4", "p5", "p6")):
        deltas, ctrs = self.rpn_head([fpn_feats[f] for f in in_features])
        level_sizes = [d.shape[1] for d in deltas]
        return torch.cat(deltas, 1), torch.cat(ctrs, 1), level_sizes

    def roi_heads(self, pooled: torch.Tensor):
        """Heads over pooled (B, S, P, P, C) features."""
        feats = self.box_head(pooled)
        deltas, iou = self.box_predictor(feats)
        emb, rec, reps = self.pln(feats)
        return deltas, iou, emb, reps, self.classifier(rec)


def build_model(spec: ModelSpec, device: Optional[Union[str, torch.device]] = None,
                state_dict: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0) -> OpensetRCNN:
    """The detector on ``device`` (the GPU unless the caller names one), in
    eval mode, with ``state_dict`` or a seeded random init."""
    device = resolve_device(device)
    model = OpensetRCNN(spec)
    if state_dict is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device=device, memory_format=torch.channels_last).eval()


def compute_anchors(spec: ModelSpec, image_hw: Tuple[int, int]) -> Tuple[np.ndarray, List[int]]:
    per_level = fpn_anchors(image_hw, RPN_STRIDES, spec.anchor_sizes, spec.anchor_aspect_ratios)
    return np.concatenate(per_level, 0), [a.shape[0] for a in per_level]


Mark = Optional[Callable[[str], None]]


def inference_forward(
    model: OpensetRCNN,
    images: torch.Tensor,
    image_hw: torch.Tensor,
    anchors: torch.Tensor,
    level_sizes: Sequence[int],
    mark: Mark = None,
) -> RawDetections:
    """Device part of inference. ``mark(stage)``, when given, is called after
    each stage ("backbone", "rpn", "roi_align", "heads") so a caller can
    time them; it is not called otherwise."""
    spec = model.spec
    fpn_feats = model.features(images, image_hw)
    if mark:
        mark("backbone")
    pred_deltas, pred_ctr, _ = model.rpn_predictions(fpn_feats)
    proposals = select_proposals(
        anchors, pred_deltas, pred_ctr, level_sizes, image_hw,
        Box2BoxTransformLinear(normalize_by_size=True),
        pre_topk=spec.pre_nms_topk_test, min_box_size=spec.min_box_size,
    )
    if mark:
        mark("rpn")
    pooled = pool_features(fpn_feats, proposals.boxes, strides=ROI_STRIDES,
                           resolution=spec.pooler_resolution, sampling_ratio=spec.roi_sampling_ratio)
    if mark:
        mark("roi_align")
    deltas, iou, emb, reps, logits = model.roi_heads(pooled)
    raw = raw_detections(
        proposals, deltas, iou, emb, reps, logits, image_hw,
        Box2BoxTransform(spec.bbox_reg_weights), spec.num_known_classes, spec.reps_per_class,
        mean_type=spec.mean_type, distance_type=spec.distance_type,
    )
    if mark:
        mark("heads")
    return raw
