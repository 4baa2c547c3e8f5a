"""The serving entry points: images in, open-set detections or proposals out.

``Predictor`` is the port's counterpart of ``CompiledInference``
(``openset_rcnn_tpu/evaluation/testing.py:39-142``): the device forward
(``inference_forward``, ``raw``) followed by the fused cascade
(``models/serving.py``, ``cascade``), with anchors kept per image bucket.
PyTorch runs eagerly, so there is nothing to compile; the forward and the
cascade are two calls, as the JAX version's two chained jits.
``ProposalPredictor`` is the counterpart of ``CompiledProposals``
(``testing.py:145-195``): backbone, CF-RPN and the top-k proposals only.

Each call runs under ``device.entry_numerics``: f32 without TF32 and bf16
matmuls without reduced-precision reductions, whatever the caller's flags.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from ..device import entry_numerics, resolve_device
from ..models.detector import Mark, ModelSpec, build_model, compute_anchors, inference_forward
from ..models.rpn import select_proposals
from ..models.serving import ServeDetections, fused_cascade
from ..ops.box_transforms import Box2BoxTransformLinear
from ..ops.nms import KeepFn, nms_keep
from ..structures import Proposals, RawDetections
from ..utils import tracing
from .postprocess import PostprocessConfig


def serve_cascade(raw: RawDetections, pc: PostprocessConfig, keep_fn: KeepFn = nms_keep) -> ServeDetections:
    """The fused cascade with the settings of ``pc``: ``Predictor.cascade``
    and the exported serving program (``tools/export_serving.py``)."""
    return fused_cascade(
        raw,
        obj_thresh=pc.obj_score_thresh,
        unk_thr=pc.unk_thr,
        known_score_thresh=pc.known_score_thresh,
        known_nms_thresh=pc.known_nms_thresh,
        known_topk=pc.known_topk,
        unknown_score_thresh=pc.unknown_score_thresh,
        unknown_nms_thresh=pc.unknown_nms_thresh,
        unknown_topk=pc.unknown_topk,
        unknown_id=pc.unknown_id,
        stage1_topk=pc.detections_per_image,
        max_known_candidates=max(2 * pc.detections_per_image, 2000),
        keep_fn=keep_fn,
    )


class _OnDevice:
    """The detector on one device with its anchors per image bucket."""

    def __init__(self, cfg, device: Optional[Union[str, torch.device]] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0):
        self.device = resolve_device(device)
        self.spec = ModelSpec.from_cfg(cfg)
        self.model = build_model(self.spec, self.device, state_dict, seed)
        self._anchors: Dict[Tuple[int, int], Tuple[torch.Tensor, list]] = {}

    def _bucket_anchors(self, bucket: Tuple[int, int]):
        if bucket not in self._anchors:
            anchors, level_sizes = compute_anchors(self.spec, bucket)
            self._anchors[bucket] = (torch.from_numpy(anchors).to(self.device), level_sizes)
        return self._anchors[bucket]


class Predictor(_OnDevice):
    """Open-set inference on one device, for every backbone the port builds.

    Args:
        cfg: a CfgNode (e.g. configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml
            merged into the defaults).
        device: the GPU unless given; with no GPU and no explicit device it
            raises (there is no CPU fallback). ``"cpu"`` runs the plain
            PyTorch versions of the kernels.
        state_dict: weights in the port's naming (``utils/jax_params.py``
            converts JAX params); a seeded random init when None.
        seed: seed of that random init.
        post_cfg: the cascade's settings; from ``cfg`` when None (with
            GraspNet's known-index -> contiguous-id table of the first test
            dataset when ``OPENDET_BENCHMARK`` is false).
    """

    def __init__(self, cfg, device: Optional[Union[str, torch.device]] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                 post_cfg: Optional[PostprocessConfig] = None):
        super().__init__(cfg, device, state_dict, seed)
        if post_cfg is None:
            from ..engine.train_loop import class_id_table

            post_cfg = PostprocessConfig.from_cfg(cfg, cfg.OPENDET_BENCHMARK, class_id_table(cfg))
        self.post_cfg = post_cfg

    @torch.inference_mode()
    @entry_numerics()
    def raw(self, images: torch.Tensor, image_hw: torch.Tensor, mark: Mark = None) -> RawDetections:
        """Per-proposal raw outputs for (B, H, W, 3) raw BGR pixels padded to
        one bucket, with each image's true (h, w) in ``image_hw`` (B, 2)."""
        images = images.to(self.device)
        image_hw = image_hw.to(self.device, torch.float32)
        anchors, level_sizes = self._bucket_anchors(tuple(images.shape[1:3]))
        return inference_forward(self.model, images, image_hw, anchors, level_sizes, mark)

    @torch.inference_mode()
    @entry_numerics()
    def cascade(self, raw: RawDetections, keep_fn: KeepFn = nms_keep) -> ServeDetections:
        return serve_cascade(raw, self.post_cfg, keep_fn)

    @entry_numerics()
    def __call__(self, images: torch.Tensor, image_hw: torch.Tensor, mark: Mark = None) -> ServeDetections:
        """Padded open-set detections (network-input coordinates) for a batch.
        ``mark`` is called after each stage, "cascade" last (see
        ``inference_forward``)."""
        with tracing.span("predict"):
            out = self.cascade(self.raw(images, image_hw, mark))
        if mark:
            mark("cascade")
        return out


class ProposalPredictor(_OnDevice):
    """Backbone + CF-RPN + per-level top-k proposals on one device: the
    device side of the box-proposal AR task. ``cfg``, ``device``,
    ``state_dict`` and ``seed`` as ``Predictor``'s."""

    @torch.inference_mode()
    @entry_numerics()
    def __call__(self, images: torch.Tensor, image_hw: torch.Tensor) -> Proposals:
        """(B, P) proposals in network-input coordinates for (B, H, W, 3) raw
        BGR pixels padded to one bucket."""
        images = images.to(self.device)
        image_hw = image_hw.to(self.device, torch.float32)
        anchors, level_sizes = self._bucket_anchors(tuple(images.shape[1:3]))
        deltas, ctrs, _ = self.model.rpn_predictions(self.model.features(images, image_hw))
        return select_proposals(anchors, deltas, ctrs, level_sizes, image_hw,
                                Box2BoxTransformLinear(normalize_by_size=True),
                                pre_topk=self.spec.pre_nms_topk_test, min_box_size=self.spec.min_box_size)
