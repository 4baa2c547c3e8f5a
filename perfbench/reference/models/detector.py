"""OpensetRCNN: the two-stage open-set detector, training losses and
inference forward.

Port of ``openset_rcnn_tpu/models/detector.py:48-499``: ``ModelSpec.from_cfg``,
the class-id maps (``opendet_id_map``, ``known_ids_id_map``), the module
holding every parameter, anchors per image bucket,
``training_losses_and_stats`` (the six losses and ten training scalars of
one batch) and ``inference_forward`` (preprocess -> backbone + FPN -> CF-RPN
-> proposals -> RoIAlign -> heads -> ``RawDetections``).

Layout: images enter as (B, H, W, 3) raw BGR pixels, the JAX layout; the
trunk runs NCHW in ``channels_last`` memory, so on the GPU the FPN maps are
NHWC-contiguous for the RoIAlign kernel.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..ops.anchors import fpn_anchors
from ..ops.box_transforms import Box2BoxTransform, Box2BoxTransformLinear
from ..ops.losses import LOCAL, LocalSum
from ..ops.roi_align import ADAPTIVE
from ..ops.sampling import draw_uniforms
from ..structures import ImageBatch, RawDetections
from ...harness import specs
from .fpn import FPN
from .roi_heads import (
    ROI_ALIGN_IMPLS,
    BoxHead,
    BoxIouPredictor,
    KnownClassifier,
    PLNHead,
    box_iou_losses,
    classifier_loss,
    label_and_sample_proposals,
    pln_loss,
    pool_features,
    raw_detections,
)
from .rpn import ClsFreeRPNHead, rpn_losses, rpn_targets, select_proposals

RPN_STRIDES = (4, 8, 16, 32, 64)
ROI_STRIDES = (4, 8, 16, 32)


class ModelSpec(NamedTuple):
    """Static hyperparameters distilled from a CfgNode: the fields of the JAX
    ModelSpec that the serving and training paths read, under the same
    names."""

    num_classes: int
    num_known_classes: int
    pixel_mean: Tuple[float, ...]
    pixel_std: Tuple[float, ...]
    anchor_sizes: Tuple[Tuple[float, ...], ...]
    anchor_aspect_ratios: Tuple[float, ...]
    # rpn
    rpn_batch_size: int
    rpn_positive_fraction: float
    rpn_obj_positive_fraction: float
    rpn_reg_thresholds: Tuple[float, float]
    rpn_obj_thresholds: Tuple[float, float]
    rpn_loc_weight: float
    rpn_ctr_weight: float
    rpn_box_reg_loss_type: str
    rpn_ctr_smooth_l1_beta: float
    pre_nms_topk_train: int
    pre_nms_topk_test: int
    min_box_size: float
    # roi
    roi_batch_size: int
    roi_positive_fraction: float
    roi_iou_threshold: float
    fc_dim: int
    pooler_resolution: int
    roi_sampling_ratio: int
    bbox_reg_weights: Tuple[float, ...]
    box_reg_loss_type: str
    box_smooth_l1_beta: float
    iou_smooth_l1_beta: float
    box_loss_weight: float
    iou_loss_weight: float
    cls_loss_weight: float
    mean_type: str
    # pln
    emd_dim: int
    distance_type: str
    reps_per_class: int
    pln_alpha: float
    pln_beta: float
    pln_iou_threshold: float
    pln_loss_weight: float
    # mapping
    id_map: Tuple[int, ...]  # contiguous id (+bg) -> known index / -1
    # misc
    freeze_at: int
    compute_dtype: str
    rpn_delta_bias_init: float
    roi_align_impl: str
    roi_align_bwd: str

    @staticmethod
    def from_cfg(cfg, id_map: Optional[Sequence[int]] = None) -> "ModelSpec":
        """The spec of ``cfg``. ``id_map`` maps each contiguous class id and
        the background to its known index or -1; when None it is the map of
        ``cfg``: the OpenDet map (``OPENDET_BENCHMARK``)."""
        m = cfg.MODEL
        if id_map is None:
            if not cfg.OPENDET_BENCHMARK:
                raise ValueError("the reference takes the id map of a non-OpenDet config from its caller")
            id_map = opendet_id_map(m.ROI_HEADS.NUM_CLASSES, m.ROI_HEADS.NUM_KNOWN_CLASSES)
        return ModelSpec(
            num_classes=m.ROI_HEADS.NUM_CLASSES,
            num_known_classes=m.ROI_HEADS.NUM_KNOWN_CLASSES,
            pixel_mean=tuple(m.PIXEL_MEAN),
            pixel_std=tuple(m.PIXEL_STD),
            anchor_sizes=tuple(tuple(s) for s in m.ANCHOR_GENERATOR.SIZES),
            anchor_aspect_ratios=tuple(m.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
            rpn_batch_size=m.RPN.BATCH_SIZE_PER_IMAGE,
            rpn_positive_fraction=m.RPN.POSITIVE_FRACTION,
            rpn_obj_positive_fraction=m.RPN.POSITIVE_FRACTION_OBJECTNESS,
            rpn_reg_thresholds=tuple(m.RPN.IOU_THRESHOLDS),
            rpn_obj_thresholds=tuple(m.RPN.IOU_THRESHOLDS_OBJECTNESS),
            rpn_loc_weight=m.RPN.BBOX_REG_LOSS_WEIGHT * m.RPN.LOSS_WEIGHT,
            rpn_ctr_weight=m.RPN.CTR_REG_LOSS_WEIGHT * m.RPN.LOSS_WEIGHT,
            rpn_box_reg_loss_type=m.RPN.BBOX_REG_LOSS_TYPE,
            rpn_ctr_smooth_l1_beta=m.RPN.CTR_SMOOTH_L1_BETA,
            pre_nms_topk_train=m.RPN.PRE_NMS_TOPK_TRAIN,
            pre_nms_topk_test=m.RPN.PRE_NMS_TOPK_TEST,
            min_box_size=float(m.PROPOSAL_GENERATOR.MIN_SIZE),
            roi_batch_size=m.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
            roi_positive_fraction=m.ROI_HEADS.POSITIVE_FRACTION,
            roi_iou_threshold=m.ROI_HEADS.IOU_THRESHOLDS[0],
            fc_dim=m.ROI_BOX_HEAD.FC_DIM,
            pooler_resolution=m.ROI_BOX_HEAD.POOLER_RESOLUTION,
            roi_sampling_ratio=cfg.TPU.ROI_SAMPLING_RATIO,
            bbox_reg_weights=tuple(m.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
            box_reg_loss_type=m.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE,
            box_smooth_l1_beta=m.ROI_BOX_HEAD.SMOOTH_L1_BETA,
            iou_smooth_l1_beta=m.ROI_BOX_HEAD.IOU_SMOOTH_L1_BETA,
            box_loss_weight=m.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT,
            iou_loss_weight=m.ROI_BOX_HEAD.IOU_REG_LOSS_WEIGHT,
            cls_loss_weight=m.ROI_BOX_HEAD.CLS_LOSS_WEIGHT,
            mean_type=m.ROI_HEADS.MEAN_TYPE,
            emd_dim=m.PLN.EMD_DIM,
            distance_type=m.PLN.DISTANCE_TYPE,
            reps_per_class=m.PLN.REPS_PER_CLASS,
            pln_alpha=m.PLN.ALPHA,
            pln_beta=m.PLN.BETA,
            pln_iou_threshold=m.PLN.IOU_THRESHOLD,
            pln_loss_weight=m.PLN.LOSS_WEIGHT,
            id_map=tuple(id_map),
            freeze_at=m.BACKBONE.FREEZE_AT,
            compute_dtype=cfg.TPU.DTYPE,
            rpn_delta_bias_init=m.RPN.get("DELTA_BIAS_INIT", 0.0),
            roi_align_impl=cfg.TPU.ROI_ALIGN_IMPL,
            roi_align_bwd=cfg.TPU.ROI_ALIGN_BWD,
        )


def opendet_id_map(num_classes: int, num_known: int) -> List[int]:
    """OpenDet benchmark mapping (``openset_rcnn_tpu/models/detector.py:172-180``):
    contiguous ids < num_known map to themselves, background (num_classes) to
    num_known, every other id to -1."""
    out = [-1] * (num_classes + 1)
    for i in range(num_known):
        out[i] = i
    out[num_classes] = num_known
    return out


def known_ids_id_map(num_classes: int, known_contiguous_ids: Sequence[int]) -> List[int]:
    """GraspNet-style mapping (``openset_rcnn_tpu/models/detector.py:183-191``):
    sorted known contiguous ids map to 0..K-1, background to K, every other
    id to -1."""
    out = [-1] * (num_classes + 1)
    for i, v in enumerate(sorted(known_contiguous_ids)):
        out[v] = i
    out[num_classes] = len(known_contiguous_ids)
    return out


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class OpensetRCNN(nn.Module):
    """Every parameter of the detector of configuration ``cfg``; the
    functions below do the rest.

    The backbone is the trunk that ``MODEL.BACKBONE.NAME`` names, built by
    ``backbones/<name>.py`` (``harness/specs.py::backbone``), under an FPN
    of the widths it gives, or with no ``fpn`` where it emits the pyramid
    itself. It runs in float32 or bfloat16 (``TPU.DTYPE``; bf16 covers the
    trunk, FPN, RPN head and box head, with parameters, losses and the other
    heads in f32, as the JAX module) with the static RoIAlign grid or the
    adaptive one (``TPU.ROI_SAMPLING_RATIO -1``, which pools at the gather
    levels with f32 backward accumulators, see ``pool_features``).
    """

    def __init__(self, cfg):
        super().__init__()
        spec = ModelSpec.from_cfg(cfg)
        if spec.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"TPU.DTYPE must be one of {tuple(COMPUTE_DTYPES)}, not {spec.compute_dtype!r}")
        if spec.roi_sampling_ratio < 1 and spec.roi_sampling_ratio != ADAPTIVE:
            raise ValueError(f"TPU.ROI_SAMPLING_RATIO must be >= 1 or -1 (adaptive), not {spec.roi_sampling_ratio}")
        if spec.roi_align_impl not in ROI_ALIGN_IMPLS:
            raise ValueError(f"TPU.ROI_ALIGN_IMPL must be one of {ROI_ALIGN_IMPLS}, not {spec.roi_align_impl!r}")
        self.spec = spec
        dtype = COMPUTE_DTYPES[spec.compute_dtype]
        head_dtype = None if dtype == torch.float32 else dtype  # the JAX heads' dtype
        num_anchors = len(spec.anchor_aspect_ratios) * len(spec.anchor_sizes[0])
        self.backbone, fpn_in = specs.backbone("reference", cfg.MODEL.BACKBONE.NAME).build(cfg, dtype)
        self.fpn = None if fpn_in is None else FPN(out_channels=256, compute_dtype=dtype, in_channels=fpn_in)
        self.rpn_head = ClsFreeRPNHead(256, num_anchors, spec.rpn_delta_bias_init, compute_dtype=head_dtype)
        self.box_head = BoxHead(in_dim=256 * spec.pooler_resolution**2, fc_dim=spec.fc_dim,
                                compute_dtype=head_dtype)
        self.box_predictor = BoxIouPredictor(spec.fc_dim)
        self.pln = PLNHead(spec.fc_dim, spec.emd_dim, spec.num_known_classes, spec.reps_per_class)
        self.classifier = KnownClassifier(spec.fc_dim, spec.num_known_classes)
        self.register_buffer("pixel_mean", torch.tensor(spec.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(spec.pixel_std, dtype=torch.float32), persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX module's initializers, drawn from ``generator``."""
        for m in (self.backbone, self.fpn, self.rpn_head, self.box_head,
                  self.box_predictor, self.pln, self.classifier):
            if m is not None:
                m.reset_parameters(generator)

    @property
    def branch_rates(self) -> List[float]:
        """The drop-path rate of every residual branch of the backbone, in
        call order (empty for a trunk that drops none)."""
        return getattr(self.backbone, "branch_rates", [])

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

    def features(self, images: torch.Tensor, image_hw: Optional[torch.Tensor] = None,
                 drop_path: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """{p2..p6}. ``drop_path``: the backbone's per-sample keep masks,
        (len(branch_rates), B), in training only; None turns drop-path off."""
        x = self.preprocess(images, image_hw)
        feats = self.backbone(x) if drop_path is None else self.backbone(x, drop_path=drop_path)
        return feats if self.fpn is None else self.fpn(feats)

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


def build_model(cfg, device: Union[str, torch.device], state_dict: Dict[str, torch.Tensor]) -> OpensetRCNN:
    """The detector of ``cfg`` on ``device`` with ``state_dict``, in eval
    mode."""
    model = OpensetRCNN(cfg)
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
                           resolution=spec.pooler_resolution, sampling_ratio=spec.roi_sampling_ratio,
                           impl=spec.roi_align_impl)
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


COUNT_STATS = ("rpn/num_pos_anchors", "rpn/num_neg_anchors", "rpn/obj_num_pos_anchors", "rpn/obj_num_neg_anchors",
               "rpn/num_proposals", "roi_head/num_fg_samples", "roi_head/num_bg_samples")


def drop_path_masks(rates: Sequence[float], batch_size: int, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """(len(rates), B) per-sample keep masks, keep where u < 1 - rate (the
    Bernoulli draw of JAX's ``_drop_path``), u uniform from ``generator``."""
    u = draw_uniforms((len(rates), batch_size), device, generator)
    return u < torch.tensor([1.0 - r for r in rates], device=device)[:, None]


def sampling_draws(model: OpensetRCNN, spec: ModelSpec, batch_size: int, num_anchors: int,
                   level_sizes: Sequence[int], num_gt: int, generator: torch.Generator,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """Every random draw of a training step on ``batch_size`` images, from
    ``generator`` in this order: "drop_path" (len(model.branch_rates), B)
    keep masks when the backbone drops paths; "rpn" (B, 2, 2, R) for
    ``rpn_targets``; "roi" (B, 3, P + G) for ``label_and_sample_proposals``,
    with P = sum over levels of min(pre_nms_topk_train, level size) and G
    ``num_gt``. The one place a training step draws: a data-parallel rank
    draws the global batch's and keeps its images' rows."""
    out = {}
    if any(r > 0 for r in model.branch_rates):
        out["drop_path"] = drop_path_masks(model.branch_rates, batch_size, generator, device)
    out["rpn"] = draw_uniforms((batch_size, 2, 2, num_anchors), device, generator)
    p = sum(min(spec.pre_nms_topk_train, s) for s in level_sizes) + num_gt
    out["roi"] = draw_uniforms((batch_size, 3, p), device, generator)
    return out


def training_losses_and_stats(
    model: OpensetRCNN,
    batch: ImageBatch,
    spec: ModelSpec,
    anchors: torch.Tensor,
    level_sizes: Sequence[int],
    uniforms: Mapping[str, torch.Tensor],
    mark: Mark = None,
    global_sum: LocalSum = LOCAL,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The six losses and ten training scalars of one batch.

    Port of ``openset_rcnn_tpu/models/detector.py:343-466``. ``uniforms``
    holds the step's random draws (``sampling_draws``, or a test's): "rpn"
    (B, 2, 2, R) and "roi" (B, 3, P + G) for the samplers (see
    ``rpn_targets`` and ``label_and_sample_proposals``), and, when the
    backbone drops paths (a trunk with ``branch_rates`` above 0; JAX's
    ``dropout`` stream), "drop_path", (len(model.branch_rates), B) bool keep masks.
    Drop-path is on here only: ``inference_forward`` never passes masks,
    whatever the module's ``training`` flag. Targets and
    proposals carry no gradient (the JAX ``stop_gradient`` on the
    proposals' inputs). ``mark(stage)``, when
    given, is called after each stage of the forward ("backbone", "rpn":
    head, targets and losses, "sampling": proposals and ROI sampling,
    "roi_align", "heads": heads, ROI losses and scalars).

    ``global_sum`` (``ops/losses.py``): on a data-parallel rank, the sum over
    the data group. The batch is then this rank's share of the global batch;
    every loss is this rank's numerator over the global batch's denominator
    (JAX's losses are global-batch values under GSPMD), so the ranks' losses
    add up to the one-process loss, and the scalars are the global batch's:
    counts summed, ratios of summed numerators and denominators.
    """
    linear_tf = Box2BoxTransformLinear(normalize_by_size=True)
    keep = uniforms["drop_path"] if any(r > 0 for r in model.branch_rates) else None
    fpn_feats = model.features(batch.images, batch.image_hw, drop_path=keep)
    if mark:
        mark("backbone")
    pred_deltas, pred_ctr, _ = model.rpn_predictions(fpn_feats)
    gt = batch.gt

    targets = rpn_targets(
        anchors, gt,
        batch_size_per_image=spec.rpn_batch_size,
        positive_fraction=spec.rpn_positive_fraction,
        objectness_positive_fraction=spec.rpn_obj_positive_fraction,
        reg_thresholds=spec.rpn_reg_thresholds,
        obj_thresholds=spec.rpn_obj_thresholds,
        uniforms=uniforms["rpn"],
    )
    losses = rpn_losses(
        anchors, pred_deltas, pred_ctr, targets, linear_tf,
        batch_size_per_image=spec.rpn_batch_size,
        loc_weight=spec.rpn_loc_weight,
        ctr_weight=spec.rpn_ctr_weight,
        box_reg_loss_type=spec.rpn_box_reg_loss_type,
        ctr_smooth_l1_beta=spec.rpn_ctr_smooth_l1_beta,
        global_sum=global_sum,
    )
    if mark:
        mark("rpn")
    proposals = select_proposals(
        anchors, pred_deltas.detach(), pred_ctr.detach(), level_sizes, batch.image_hw, linear_tf,
        pre_topk=spec.pre_nms_topk_train, min_box_size=spec.min_box_size,
    )
    rois = label_and_sample_proposals(
        proposals, gt,
        num_samples=spec.roi_batch_size,
        positive_fraction=spec.roi_positive_fraction,
        iou_threshold=spec.roi_iou_threshold,
        num_classes=spec.num_classes,
        uniforms=uniforms["roi"],
    )
    if mark:
        mark("sampling")
    pooled = pool_features(fpn_feats, rois.boxes, strides=ROI_STRIDES,
                           resolution=spec.pooler_resolution, sampling_ratio=spec.roi_sampling_ratio,
                           impl=spec.roi_align_impl)
    if mark:
        mark("roi_align")
    deltas, iou, emb, reps, logits = model.roi_heads(pooled)
    losses.update(box_iou_losses(
        deltas, iou, rois, Box2BoxTransform(spec.bbox_reg_weights), spec.num_classes,
        box_weight=spec.box_loss_weight,
        iou_weight=spec.iou_loss_weight,
        box_smooth_l1_beta=spec.box_smooth_l1_beta,
        iou_smooth_l1_beta=spec.iou_smooth_l1_beta,
        box_reg_loss_type=spec.box_reg_loss_type,
        global_sum=global_sum,
    ))
    id_map = torch.tensor(spec.id_map, dtype=torch.int64, device=anchors.device)
    losses["loss_dml"] = pln_loss(
        emb, reps, rois, id_map, spec.num_known_classes, spec.reps_per_class,
        spec.pln_alpha, spec.pln_beta, spec.pln_iou_threshold, spec.pln_loss_weight, spec.distance_type,
        global_sum,
    )
    losses["loss_cls"] = classifier_loss(logits, rois, id_map, spec.cls_loss_weight, global_sum)

    # the reference's EventStorage scalars over the global batch, kept on the device
    B = batch.images.shape[0] * global_sum.size
    labels = id_map[rois.gt_classes]
    pred = torch.argmax(logits.detach(), dim=-1)
    valid = rois.valid & (labels >= 0)
    fg = valid & (labels < spec.num_known_classes)
    sums = global_sum(torch.stack([
        (targets.reg_labels == 1).sum(), (targets.reg_labels == 0).sum(),
        (targets.obj_labels == 1).sum(), (targets.obj_labels == 0).sum(),
        proposals.valid.sum(), rois.is_fg.sum(), (rois.valid & ~rois.is_fg).sum(),
        ((pred == labels) & valid).sum(), ((pred == labels) & fg).sum(),
        ((pred == spec.num_known_classes) & fg).sum(), valid.sum(), fg.sum(),
    ]))
    stats = {name: sums[i] / B for i, name in enumerate(COUNT_STATS)}
    n_valid = torch.clamp(sums[10], min=1)
    n_fg = torch.clamp(sums[11], min=1)
    stats["softmax_classifier/cls_accuracy"] = sums[7] / n_valid
    stats["softmax_classifier/fg_cls_accuracy"] = sums[8] / n_fg
    stats["softmax_classifier/false_negative"] = sums[9] / n_fg
    if mark:
        mark("heads")
    return losses, stats
