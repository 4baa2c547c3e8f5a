"""The reference's entry points: a configuration file's detector in plain
PyTorch, its training steps and its detections.

``Reference(cfg, state_dict, device, precision)`` builds the detector of a
configuration file's ``cfg`` in the precision the configuration states
(``TPU.DTYPE``: f32, or bf16 activations with f32 parameters, losses and
heads), loads the given weights and runs in one of three precisions:

* ``stated``: the configuration's, with TF32 off and bf16 products summed
  in f32, cuDNN's deterministic algorithms in training: the reference;
* ``tf32``: TF32 on for f32 convolutions and matrix products: the control
  of a configuration that states f32;
* ``fp8``: as stated, with every convolution's and linear layer's input and
  weight rounded to fp8 first (e4m3, one scale a tensor from its largest
  magnitude, the gradient passed straight through), as fp8 products take
  them: the control of a configuration that states bf16.

Pooling takes P2-P5 rounded to bf16 whatever the compute dtype (the
configuration's pooling dtype) and sums in f32, forward and backward.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .engine.optimizer import freeze, warmup_multistep_schedule
from .evaluation.postprocess import FinalDetections, PostprocessConfig, finalize_serve_image
from .models.detector import (ROI_STRIDES, ModelSpec, OpensetRCNN, build_model, compute_anchors,
                              inference_forward, training_losses_and_stats)
from .models.roi_heads import pool_features
from .models.serving import fused_cascade
from .structures import GroundTruth, ImageBatch

PRECISIONS = ("stated", "tf32", "fp8")
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


class Cfg(dict):
    """A configuration file's nested ``cfg`` with attribute access, as the
    program's CfgNode reads."""

    def __getattr__(self, name):
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Cfg(v) if isinstance(v, dict) else v


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 at one scale for the tensor (its largest
    magnitude maps to 448), back in ``x``'s dtype; the gradient passes
    straight through."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float().mul(scale).to(x.dtype)
    return x + (q - x).detach()


@contextlib.contextmanager
def _fp8_layers() -> Iterator[None]:
    saved = (F.linear, F.conv2d, F.conv_transpose2d)

    def linear(x, w, b=None):
        return saved[0](fp8_round(x), fp8_round(w), b)

    def conv2d(x, w, b=None, *args, **kwargs):
        return saved[1](fp8_round(x), fp8_round(w), b, *args, **kwargs)

    def conv_transpose2d(x, w, b=None, *args, **kwargs):
        return saved[2](fp8_round(x), fp8_round(w), b, *args, **kwargs)

    F.linear, F.conv2d, F.conv_transpose2d = linear, conv2d, conv_transpose2d
    try:
        yield
    finally:
        F.linear, F.conv2d, F.conv_transpose2d = saved


@contextlib.contextmanager
def numerics(precision: str, deterministic: bool = False) -> Iterator[None]:
    """The flags of ``precision`` (and cuDNN's deterministic algorithms
    without autotuning when ``deterministic``), restored on exit."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision is one of {PRECISIONS}, not {precision!r}")
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = precision == "tf32"
    matmul.allow_bf16_reduced_precision_reduction = False
    flags = dict(enabled=True, benchmark=False, deterministic=True) if deterministic else {}
    try:
        with cudnn.flags(allow_tf32=precision == "tf32", **flags), \
                (_fp8_layers() if precision == "fp8" else contextlib.nullcontext()):
            yield
    finally:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = saved


def skeleton(cfg: Mapping) -> OpensetRCNN:
    """The detector's module tree on the meta device: the leaves, shapes and
    layer types that the weights are made for."""
    with torch.device("meta"):
        return OpensetRCNN(ModelSpec.from_cfg(Cfg(cfg)))


class Reference:
    def __init__(self, cfg: Mapping, state_dict: Mapping[str, torch.Tensor], device: torch.device,
                 precision: str = "stated"):
        self.cfg = Cfg(cfg)
        self.spec = ModelSpec.from_cfg(self.cfg)
        self.device = torch.device(device)
        self.precision = precision
        self.model = build_model(self.spec, self.device, {k: v.to(self.device) for k, v in state_dict.items()})
        rh, pln = self.cfg.MODEL.ROI_HEADS, self.cfg.MODEL.PLN
        self.post = PostprocessConfig(
            obj_score_thresh=rh.OBJ_SCORE_THRESH_TEST, stage1_nms_thresh=rh.NMS_THRESH_TEST,
            detections_per_image=self.cfg.TEST.DETECTIONS_PER_IMAGE, unk_thr=pln.UNK_THR,
            known_score_thresh=rh.KNOWN_SCORE_THRESH, known_nms_thresh=rh.KNOWN_NMS_THRESH,
            known_topk=rh.KNOWN_TOPK, unknown_score_thresh=rh.UNKNOWN_SCORE_THRESH,
            unknown_nms_thresh=rh.UNKNOWN_NMS_THRESH, unknown_topk=rh.UNKNOWN_TOPK,
            unknown_id=rh.NUM_CLASSES - 1 if self.cfg.OPENDET_BENCHMARK else rh.UNKNOWN_ID)
        self._anchors: Dict[Tuple[int, int], Tuple[torch.Tensor, List[int]]] = {}

    def anchors(self, bucket: Tuple[int, int]) -> Tuple[torch.Tensor, List[int]]:
        if bucket not in self._anchors:
            a, sizes = compute_anchors(self.spec, bucket)
            self._anchors[bucket] = (torch.from_numpy(a).to(self.device), sizes)
        return self._anchors[bucket]

    # ------------------------------------------------------------ serving
    @torch.no_grad()
    def detect(self, image: np.ndarray, image_hw: Tuple[int, int], original_hw: Tuple[int, int]) -> FinalDetections:
        """One padded (H, W, 3) uint8 BGR image's open-set detections in the
        original image's coordinates: forward, fused cascade, rescale."""
        images = torch.from_numpy(np.ascontiguousarray(image))[None].to(self.device)
        hw = torch.tensor([image_hw], dtype=torch.float32, device=self.device)
        anchors, sizes = self.anchors(tuple(images.shape[1:3]))
        p = self.post
        with numerics(self.precision):
            raw = inference_forward(self.model, images, hw, anchors, sizes)
            out = fused_cascade(
                raw, obj_thresh=p.obj_score_thresh, unk_thr=p.unk_thr, known_score_thresh=p.known_score_thresh,
                known_nms_thresh=p.known_nms_thresh, known_topk=p.known_topk,
                unknown_score_thresh=p.unknown_score_thresh, unknown_nms_thresh=p.unknown_nms_thresh,
                unknown_topk=p.unknown_topk, unknown_id=p.unknown_id, stage1_topk=p.detections_per_image,
                max_known_candidates=max(2 * p.detections_per_image, 2000))
        host = {k: getattr(out, k)[0].cpu().numpy() for k in ("boxes", "scores", "classes", "valid")}
        return finalize_serve_image(host["boxes"], host["scores"], host["classes"], host["valid"],
                                    image_hw, original_hw, p)

    @torch.no_grad()
    def box_head_outputs(self, images: torch.Tensor, image_hw: torch.Tensor,
                         boxes: Sequence[np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image by image, the box head's outputs of the valid proposals of
        the inference forward, and of ``boxes`` (per image, (n, 4) in
        network-input coordinates): ((N, fc), (sum n, fc))."""
        spec, props, given = self.spec, [], []
        hook = self.model.box_head.register_forward_hook(lambda m, args, out: props.append(out))
        try:
            with numerics(self.precision):
                for i in range(images.shape[0]):
                    anchors, sizes = self.anchors(tuple(images.shape[1:3]))
                    raw = inference_forward(self.model, images[i: i + 1], image_hw[i: i + 1], anchors, sizes)
                    props[-1] = props[-1][raw.valid]
                    b = torch.as_tensor(np.asarray(boxes[i], np.float32).reshape(1, -1, 4), device=self.device)
                    if b.shape[1]:
                        feats = self.model.features(images[i: i + 1], image_hw[i: i + 1])
                        pooled = pool_features(feats, b, strides=ROI_STRIDES, resolution=spec.pooler_resolution,
                                               sampling_ratio=spec.roi_sampling_ratio, impl=spec.roi_align_impl)
                        given.append(self.model.box_head(pooled)[0])
                        props.pop()  # the hook caught the given boxes' call too
        finally:
            hook.remove()
        return torch.cat(props).float(), torch.cat(given).float()

    # ----------------------------------------------------------- training
    def train(self, batches: Sequence[ImageBatch], draws: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, list]:
        """SGD steps from the loaded weights, one a batch, each with its
        sampling draws: per step the losses, and the trainable leaves'
        names, the norms of the first step's gradient as SGD takes it
        (gradient plus weight decay times the weight) and of every leaf's
        change over all the steps."""
        s = self.cfg.SOLVER
        schedule = warmup_multistep_schedule(s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_ITERS, s.WARMUP_FACTOR,
                                             s.WARMUP_METHOD)
        model = self.model.train()
        params = freeze(model, self.cfg.MODEL.BACKBONE.FREEZE_AT)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        start = [p.detach().clone() for p in params]
        momentum: List[Optional[torch.Tensor]] = [None] * len(params)
        losses, first = [], None
        for step, (batch, u) in enumerate(zip(batches, draws)):
            dev = self.device
            batch = ImageBatch(batch.images.to(dev), batch.image_hw.to(dev, torch.float32),
                               GroundTruth(batch.gt.boxes.to(dev, torch.float32), batch.gt.classes.to(dev),
                                           batch.gt.valid.to(dev)))
            anchors, sizes = self.anchors(tuple(batch.images.shape[1:3]))
            for p in params:
                p.grad = None
            with numerics(self.precision, deterministic=True):
                step_losses, _ = training_losses_and_stats(model, batch, self.spec, anchors, sizes,
                                                           {k: v.to(dev) for k, v in u.items()})
                total = sum(step_losses.values())
                total.backward()
            if s.CLIP_GRADIENTS.ENABLED:
                raise NotImplementedError("the reference does not clip gradients")
            lr = schedule(step)
            with torch.no_grad():
                for i, p in enumerate(params):
                    d = p.grad + s.WEIGHT_DECAY * p
                    momentum[i] = d.clone() if momentum[i] is None else momentum[i] * s.MOMENTUM + d
                    p.sub_(momentum[i] * lr)
            if first is None:
                first = torch.stack([torch.linalg.vector_norm(m.double()) for m in momentum]).cpu().tolist()
            losses.append({k: float(v.detach()) for k, v in step_losses.items()} | {"total_loss": float(total.detach())})
        moved = torch.stack([torch.linalg.vector_norm((p.detach() - p0).double())
                             for p, p0 in zip(params, start)]).cpu().tolist()
        return {"names": names, "losses": losses, "first_grad_norms": first, "change_norms": moved}
