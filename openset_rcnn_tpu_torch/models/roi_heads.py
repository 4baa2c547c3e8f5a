"""Open-set ROI heads: proposal sampling, RoI pooling, the four heads, their
losses and raw detections.

Port of ``openset_rcnn_tpu/models/roi_heads.py:45-382``:
  * ``BoxHead``: flatten + 2x FC-1024 + ReLU (in bf16 under a bf16 compute
    dtype), f32 out;
  * ``BoxIouPredictor``: class-agnostic box deltas + sigmoid IoU;
  * ``PLNHead``: encoder/decoder 1024<->256 and learnable prototypes;
  * ``KnownClassifier``: (K+1)-way linear classifier on reconstructed features;
  * ``label_and_sample_proposals``: GT-augmented proposals, matched at IoU 0.5,
    512 balanced samples per image;
  * ``box_iou_losses``, ``pln_loss``, ``classifier_loss``: the ROI losses;
  * ``pool_features``: differentiable RoIAlignV2 7x7 over P2-P5 in bf16,
    returned in f32, at the gather path's levels or the TPU kernels'
    window-fit levels (``impl``), with f32 or bf16 backward accumulators;
  * ``raw_detections``: box decoding, objectness, prototype distances, softmax.

Layout: pooled features are (B, S, 7, 7, C), the JAX flatten order, so
``fc1``'s weight is the JAX kernel transposed, with no row permutation.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_transforms import Box2BoxTransform
from ..ops.boxes import clip_boxes, pairwise_iou
from ..ops.losses import LOCAL, LocalSum, dense_box_regression_loss, masked_sum, smooth_l1, softmax_cross_entropy
from ..ops.matcher import match
from ..ops.roi_align import ADAPTIVE, RoIAlignFunction, assign_levels, assign_levels_window_fit
from ..ops.sampling import sample_balanced_indices
from ..structures import GroundTruth, Proposals, RawDetections, SampledRois


def _dense_init(layer: nn.Linear, std: float, generator: torch.Generator) -> None:
    nn.init.normal_(layer.weight, std=std, generator=generator)
    nn.init.zeros_(layer.bias)


class BoxHead(nn.Module):
    """FastRCNNConvFCHead equivalent: flatten + 2x FC + ReLU. The FCs run in
    ``compute_dtype`` (None: the input's dtype) with the f32 weights cast to
    it; the features come out f32 for the numerics-sensitive heads.

    ``shard(layout)`` makes both FCs tensor-parallel over the layout's model
    group (``TPU.MESH_MODEL`` > 1, ``parallel/mesh.py``): fc1 keeps its rank's
    ``fc_dim / M`` output rows (column-parallel; the ReLU acts on the shard),
    fc2 the matching input columns (row-parallel); fc2's partial outputs are
    summed over the group in f32, its bias added once after the sum and the
    result rounded once to the compute dtype, as the one-process GEMM sums in
    f32 and rounds once. The gradient of fc1's input is summed over the group
    in the backward. ``parallel.mesh.shard_state_dict`` cuts a whole
    (one-process) state dict to a rank's shards."""

    def __init__(self, in_dim: int, fc_dim: int = 1024, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc1 = nn.Linear(in_dim, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)
        self.layout = None  # a parallel.mesh.Layout once sharded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(*x.shape[:-3], -1)
        if self.layout is not None:
            return self._forward_sharded(x)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        for fc in (self.fc1, self.fc2):
            x = torch.relu(F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype)))
        return x.float()

    def _forward_sharded(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import copy_to_model_group, sum_over_model_group

        x = copy_to_model_group(x, self.layout)
        dtype = self.compute_dtype or x.dtype
        x = x.to(dtype)
        h = torch.relu(F.linear(x, self.fc1.weight.to(dtype), self.fc1.bias.to(dtype)))
        partial = F.linear(h.float(), self.fc2.weight.to(dtype).float())
        out = sum_over_model_group(partial, self.layout) + self.fc2.bias.to(dtype).float()
        return torch.relu(out.to(dtype)).float()

    def shard(self, layout) -> None:
        """Keep this rank's shards of fc1 and fc2 (in place)."""
        from ..parallel.mesh import shard

        for fc, dim in ((self.fc1, 0), (self.fc2, 1)):
            fc.weight = nn.Parameter(shard(fc.weight.data, dim, layout), requires_grad=fc.weight.requires_grad)
        self.fc1.bias = nn.Parameter(shard(self.fc1.bias.data, 0, layout), requires_grad=self.fc1.bias.requires_grad)
        self.fc1.out_features = self.fc2.in_features = self.fc1.weight.shape[0]
        self.layout = layout

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Caffe2 Xavier (uniform, fan_in) weights, zero biases; a sharded
        head draws the whole matrices, as one process does, and keeps its
        shards."""
        from ..parallel.mesh import shard

        m = 1 if self.layout is None else self.layout.model
        for fc, dim, fan_in in ((self.fc1, 0, self.fc1.in_features), (self.fc2, 1, self.fc2.in_features * m)):
            whole = list(fc.weight.shape)
            whole[dim] *= m
            bound = math.sqrt(3.0 / fan_in)
            w = nn.init.uniform_(torch.empty(whole, device=fc.weight.device), -bound, bound, generator=generator)
            with torch.no_grad():
                fc.weight.copy_(w if m == 1 else shard(w, dim, self.layout))
            nn.init.zeros_(fc.bias)


class BoxIouPredictor(nn.Module):
    """Class-agnostic box deltas + sigmoid IoU prediction."""

    def __init__(self, in_dim: int = 1024):
        super().__init__()
        self.bbox_pred = nn.Linear(in_dim, 4)
        self.iou_pred = nn.Linear(in_dim, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.bbox_pred(x), torch.sigmoid(self.iou_pred(x))[..., 0]

    def reset_parameters(self, generator: torch.Generator) -> None:
        _dense_init(self.bbox_pred, 0.001, generator)
        _dense_init(self.iou_pred, 0.01, generator)


class PLNHead(nn.Module):
    """Prototype Learning Network: encoder/decoder + learnable prototypes."""

    def __init__(self, feature_dim: int = 1024, embedding_dim: int = 256,
                 num_known_classes: int = 20, reps_per_class: int = 1):
        super().__init__()
        self.encoder = nn.Linear(feature_dim, embedding_dim)
        self.decoder = nn.Linear(embedding_dim, feature_dim)
        self.representatives = nn.Parameter(torch.empty(num_known_classes * reps_per_class, embedding_dim))

    def forward(self, x: torch.Tensor):
        emb = self.encoder(x)
        return emb, self.decoder(emb), self.representatives

    def reset_parameters(self, generator: torch.Generator) -> None:
        _dense_init(self.encoder, 0.01, generator)
        _dense_init(self.decoder, 0.01, generator)
        nn.init.normal_(self.representatives, std=1.0, generator=generator)


class KnownClassifier(nn.Module):
    """(K_known + 1)-way linear classifier over reconstructed features."""

    def __init__(self, in_dim: int = 1024, num_known_classes: int = 20):
        super().__init__()
        self.cls_score = nn.Linear(in_dim, num_known_classes + 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cls_score(x)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _dense_init(self.cls_score, 0.01, generator)


# --------------------------------------------------------------------------
# Proposal labeling / sampling
# --------------------------------------------------------------------------


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for x (B, N, ...) and idx (B, S)."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(*idx.shape, *x.shape[2:]))


def label_and_sample_proposals(
    proposals: Proposals,
    gt: GroundTruth,
    num_samples: int = 512,
    positive_fraction: float = 0.25,
    iou_threshold: float = 0.5,
    num_classes: int = 80,
    *,
    uniforms: torch.Tensor,
) -> SampledRois:
    """The GT boxes are appended to the proposals (objectness 1.0; invalid GT
    rows stay masked), matched at ``iou_threshold`` without rescue, and
    ``num_samples`` balanced samples are drawn per image. ``uniforms``
    (B, 3, P + G): per image the draws of (kp, kn, kt) of the JAX key tree
    ``split(key, 3)``."""
    boxes = torch.cat([proposals.boxes, gt.boxes], dim=1)
    scores = torch.cat([proposals.scores, gt.valid.to(proposals.scores.dtype)], dim=1)
    valid = torch.cat([proposals.valid, gt.valid], dim=1)
    iou = pairwise_iou(gt.boxes, boxes)  # (B, G, P + G)
    res = match(iou, gt.valid, [iou_threshold], [0, 1], allow_low_quality_matches=False)
    matched_iou = torch.amax(torch.where(gt.valid[..., None], iou, torch.full_like(iou, -1.0)), dim=1)
    matched_iou = torch.clamp(matched_iou, min=0.0)
    has_gt = gt.valid.any(dim=1, keepdim=True)
    fg = (res.labels == 1) & valid & has_gt
    bg = (res.labels == 0) & valid
    s = sample_balanced_indices(fg, bg, num_samples, positive_fraction, uniforms)
    gt_idx = torch.gather(res.matched_idx, 1, s.indices)
    background = torch.full_like(gt_idx, num_classes)
    classes = torch.where(s.is_pos, torch.gather(gt.classes.long(), 1, gt_idx), background)
    return SampledRois(
        boxes=_take(boxes, s.indices),
        scores=_take(scores, s.indices),
        gt_boxes=_take(gt.boxes, gt_idx),
        gt_classes=torch.where(s.valid, classes, background),
        ious=_take(matched_iou, s.indices),
        is_fg=s.is_pos & s.valid,
        valid=s.valid,
    )


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def box_iou_losses(
    pred_deltas: torch.Tensor,  # (B, S, 4)
    pred_iou: torch.Tensor,     # (B, S)
    rois: SampledRois,
    transform: Box2BoxTransform,
    num_classes: int,
    box_weight: float = 1.0,
    iou_weight: float = 1.0,
    box_smooth_l1_beta: float = 0.0,
    iou_smooth_l1_beta: float = 0.0,
    box_reg_loss_type: str = "smooth_l1",
    global_sum: LocalSum = LOCAL,
) -> Dict[str, torch.Tensor]:
    """Box regression and IoU prediction over the foreground, both over the
    number of valid samples of the global batch (``global_sum``)."""
    fg = rois.is_fg & (rois.gt_classes < num_classes)
    denom = torch.clamp(global_sum(rois.valid.sum()), min=1).float()
    if box_reg_loss_type == "smooth_l1":
        gt_deltas = transform.get_deltas(rois.boxes, rois.gt_boxes)
        box_loss = masked_sum(smooth_l1(pred_deltas, gt_deltas, box_smooth_l1_beta), fg)
    elif box_reg_loss_type in ("iou", "giou", "diou", "ciou"):
        pred_boxes = transform.apply_deltas(pred_deltas, rois.boxes)
        box_loss = dense_box_regression_loss(pred_boxes, rois.gt_boxes, fg, box_reg_loss_type)
    else:
        raise ValueError(box_reg_loss_type)
    iou_loss = masked_sum(smooth_l1(pred_iou, rois.ious, iou_smooth_l1_beta), fg)
    return {
        "loss_box_reg": box_weight * box_loss / denom,
        "loss_iou": iou_weight * iou_loss / denom,
    }


def pln_loss(
    emb: torch.Tensor,     # (B, S, E) encoder output
    reps: torch.Tensor,    # (Kr, E) raw prototypes
    rois: SampledRois,
    id_map: torch.Tensor,  # (num_classes + 1,) contiguous id -> known index or -1
    num_known_classes: int,
    reps_per_class: int,
    alpha: float,
    beta: float,
    iou_threshold: float,
    loss_weight: float,
    distance_type: str = "COS",
    global_sum: LocalSum = LOCAL,
) -> torch.Tensor:
    """Instance-level contrastive loss of the PLN: intra-class and
    inter-class hinges on the foreground plus a prototype-separation hinge,
    over the number of sampled proposals (``sum(valid)``, the reference's
    ``gt_classes.numel()``) of the global batch (``global_sum``). The
    prototype term does not depend on the batch: every data-parallel rank
    computes it whole and adds its share, 1 / ``global_sum.size``, so the
    ranks' losses count it once."""
    B, S, E = emb.shape
    known_ids = id_map[rois.gt_classes]  # (B, S); -1 or known index; bg -> K
    fg = (known_ids >= 0) & (known_ids < num_known_classes) & (rois.ious > iou_threshold) & rois.valid

    x = emb.reshape(B * S, E)
    x = x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + 1e-12)
    r = reps * torch.rsqrt(torch.sum(reps * reps, -1, keepdim=True) + 1e-12)
    if distance_type == "COS":
        dist, cdist = 1.0 - x @ r.T, 1.0 - r @ r.T
    elif distance_type == "L2":
        dist = torch.sqrt(torch.clamp(torch.sum((x[:, None] - r[None]) ** 2, -1), min=1e-12))
        cdist = torch.sqrt(torch.clamp(torch.sum((r[:, None] - r[None]) ** 2, -1), min=1e-12))
    elif distance_type == "L1":
        dist = torch.sum(torch.abs(x[:, None] - r[None]), -1)
        cdist = torch.sum(torch.abs(r[:, None] - r[None]), -1)
    else:
        raise ValueError(distance_type)

    K, R = num_known_classes, reps_per_class
    min_dist = torch.amin(dist.reshape(-1, K, R), dim=2)  # (N, K)
    labels = torch.clamp(known_ids.reshape(-1), 0, K - 1)
    onehot = torch.nn.functional.one_hot(labels.long(), K).bool()
    far = torch.full_like(min_dist, 1000.0)
    intra = torch.sum(torch.where(onehot, min_dist, torch.zeros_like(min_dist)), dim=1)
    inter = torch.amin(torch.where(onehot, far, min_dist), dim=1)
    own = torch.arange(K, device=reps.device).repeat_interleave(R)
    same_class = own[:, None] == own[None, :]
    c_dist = torch.amin(torch.where(same_class, torch.full_like(cdist, 1000.0), cdist), dim=1)

    fg_flat = fg.reshape(-1)
    zero = torch.zeros_like(intra)
    loss = (
        torch.sum(torch.where(fg_flat, torch.relu(intra - alpha), zero))
        + torch.sum(torch.where(fg_flat, torch.relu(beta - inter), zero))
        + torch.sum(torch.relu(beta + alpha - c_dist)) / global_sum.size
    )
    denom = torch.clamp(global_sum(rois.valid.sum()), min=1).float()
    return loss_weight * loss / denom


def classifier_loss(
    logits: torch.Tensor,  # (B, S, K+1)
    rois: SampledRois,
    id_map: torch.Tensor,
    cls_loss_weight: float,
    global_sum: LocalSum = LOCAL,
) -> torch.Tensor:
    labels = id_map[rois.gt_classes]  # bg -> K
    valid = rois.valid & (labels >= 0)
    return cls_loss_weight * softmax_cross_entropy(logits, torch.clamp(labels, min=0), valid, global_sum)


# --------------------------------------------------------------------------
# Pooling
# --------------------------------------------------------------------------


ROI_ALIGN_IMPLS = ("auto", "gather", "pallas")
# TPU.ROI_ALIGN_BWD -> the backward's accumulator dtype ("xla": the f32
# scatter-add of the gather path, which the f32 kernel computes)
ROI_ALIGN_BWD_ACC = {"pallas": torch.float32, "xla": torch.float32, "pallas_bf16": torch.bfloat16}


def pool_features(
    fpn_feats: Dict[str, torch.Tensor],
    boxes: torch.Tensor,  # (B, S, 4)
    in_features: Sequence[str] = ("p2", "p3", "p4", "p5"),
    strides: Sequence[int] = (4, 8, 16, 32),
    resolution: int = 7,
    sampling_ratio: int = 2,
    impl: str = "gather",
    bwd_impl: str = "pallas",
) -> torch.Tensor:
    """(B, S, P, P, C) f32 RoI features, differentiable in the features (the
    boxes get no gradient). P2-P5 are cast to bf16 whatever the compute dtype
    (the JAX pooling dtype); on the GPU the channels_last NCHW maps are
    NHWC-contiguous already, so the permute below copies nothing, and the
    backward's NHWC gradients flow back through the same views.

    ``impl`` (``TPU.ROI_ALIGN_IMPL``): "gather" pools every RoI at its
    canonical FPN level, as the JAX gather path; so does "auto", which is
    what JAX resolves it to on any backend but a TPU
    (``openset_rcnn_tpu/models/detector.py:284-296``); "pallas" pools at the
    TPU kernels' window-fit level, as JAX's ``impl="pallas"``. ``bwd_impl``
    (``TPU.ROI_ALIGN_BWD``) picks the backward's accumulators:
    ``ROI_ALIGN_BWD_ACC``.

    The backward always sends the gradient to the levels the forward read.
    So ``bwd_impl="xla"`` under ``impl="pallas"`` gives the f32 ``pallas``
    gradient, bitwise. JAX differs there: its ``xla`` backward
    (``openset_rcnn_tpu/ops/roi_align.py:423-433``) assigns canonical levels
    again (``:104``), so a box that the window-fit rule moved up a level
    sends its gradient to a level its forward never read. The port keeps the
    true gradient (``tests/test_torch_port_train_ops.py``
    ``::test_xla_backward_follows_the_forward_levels``).

    The adaptive grid (``sampling_ratio == -1``, both ``*_parity.yaml``
    configs) overrides both keys, as JAX does
    (``openset_rcnn_tpu/ops/roi_align.py:387-388``, where only the gather
    formulation expresses it): it pools at the gather levels whatever
    ``impl`` says, and its backward sums into f32 accumulators (K2's f32
    mode) whatever ``bwd_impl`` says (``tests/test_torch_port_adaptive.py``
    ``::test_pool_features_adaptive_overrides_impl_and_bwd_impl``)."""
    if impl not in ROI_ALIGN_IMPLS:
        raise ValueError(f"TPU.ROI_ALIGN_IMPL must be one of {ROI_ALIGN_IMPLS}, not {impl!r}")
    if bwd_impl not in ROI_ALIGN_BWD_ACC:
        raise ValueError(f"TPU.ROI_ALIGN_BWD must be one of {tuple(ROI_ALIGN_BWD_ACC)}, not {bwd_impl!r}")
    if sampling_ratio == ADAPTIVE:
        impl, bwd_impl = "gather", "pallas"
    feats = [fpn_feats[f].to(torch.bfloat16).permute(0, 2, 3, 1).contiguous() for f in in_features]
    if impl == "pallas":
        levels = assign_levels_window_fit(boxes, strides)
    else:
        levels = assign_levels(boxes, min_level=2, max_level=2 + len(feats) - 1)
    return RoIAlignFunction.apply(boxes, levels, tuple(strides), resolution, sampling_ratio,
                                  ROI_ALIGN_BWD_ACC[bwd_impl], *feats)


def raw_detections(
    proposals: Proposals,
    pred_deltas: torch.Tensor,
    pred_iou: torch.Tensor,
    emb: torch.Tensor,
    reps: torch.Tensor,
    known_logits: torch.Tensor,
    image_hw: torch.Tensor,
    transform: Box2BoxTransform,
    num_known_classes: int,
    reps_per_class: int,
    mean_type: str = "geometric",
    distance_type: str = "COS",
) -> RawDetections:
    boxes = clip_boxes(transform.apply_deltas(pred_deltas, proposals.boxes), image_hw)
    if mean_type == "geometric":
        objectness = torch.sqrt(torch.clamp(pred_iou * proposals.scores, min=0.0))
    else:
        objectness = 0.5 * (pred_iou + proposals.scores)

    B, P, E = emb.shape
    x = emb.reshape(B * P, E)
    x = x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + 1e-12)
    r = reps * torch.rsqrt(torch.sum(reps * reps, -1, keepdim=True) + 1e-12)
    if distance_type == "COS":
        dist = 1.0 - x @ r.T
    elif distance_type == "L2":
        dist = torch.sqrt(torch.clamp(torch.sum((x[:, None] - r[None]) ** 2, -1), min=1e-12))
    else:
        dist = torch.sum(torch.abs(x[:, None] - r[None]), -1)
    per_class = torch.amin(dist.reshape(B, P, num_known_classes, reps_per_class), dim=3)
    min_dist, pln_class = torch.min(per_class, dim=2)
    return RawDetections(
        boxes=boxes,
        objectness=objectness,
        pred_iou=pred_iou,
        centerness=proposals.scores,
        min_dist=min_dist,
        pln_class=pln_class,
        known_probs=torch.softmax(known_logits, dim=-1),
        valid=proposals.valid,
    )
