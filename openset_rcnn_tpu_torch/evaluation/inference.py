"""The serving entry points: images in, open-set detections or proposals out.

``Predictor`` is the port's counterpart of ``CompiledInference``
(``openset_rcnn_tpu/evaluation/testing.py:39-142``): the device forward
(``inference_forward``, ``raw``) followed by the fused cascade
(``models/serving.py``, ``cascade``), with anchors kept per image bucket.
The forward and the cascade are two calls, as the JAX version's two chained
jits; on the GPU, ``Predictor.__call__`` replays them as CUDA graphs, one
set per input shape, so a call costs the host a few graph launches rather
than hundreds of kernel launches.
``ProposalPredictor`` is the counterpart of ``CompiledProposals``
(``testing.py:145-195``): backbone, CF-RPN and the top-k proposals only.

Each call runs under ``device.entry_numerics``: f32 without TF32 and bf16
matmuls without reduced-precision reductions, whatever the caller's flags.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from ..device import entry_numerics, resolve_device
from ..models.detector import (Mark, ModelSpec, Stage, build_model, compute_anchors, inference_forward,
                               inference_stages)
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


# A cap on the memory a Predictor's graphs hold, against a caller that sends
# shapes it did not bucket: every caller sends at most two (the two buckets;
# the eval loader pads each batch to its full size, tools/predict and the
# frame path run batch 1). A call with a further shape runs eagerly.
GRAPH_SHAPES = 4


class _StageGraphs:
    """One input shape's CUDA graphs, one per stage, captured in order into
    ``pool`` on ``stream`` from static inputs; each stage's outputs are the
    next one's inputs, and the last stage's are the static outputs."""

    def __init__(self, stages: Sequence[Stage], images: torch.Tensor, image_hw: torch.Tensor,
                 device: torch.device, pool, stream: torch.cuda.Stream):
        self.images = torch.empty(images.shape, dtype=images.dtype, device=device)
        self.image_hw = torch.empty(image_hw.shape, dtype=torch.float32, device=device)
        self.graphs: List[Tuple[str, torch.cuda.CUDAGraph]] = []
        out = (self.images, self.image_hw)
        for name, fn in stages:
            graph = torch.cuda.CUDAGraph()
            # thread_local: the eval loader's thread pins and copies batches meanwhile
            with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                out = fn(*out)
            self.graphs.append((name, graph))
        (self.out,) = out

    def replay(self, images: torch.Tensor, image_hw: torch.Tensor, mark: Mark) -> ServeDetections:
        """The outputs for these inputs, cloned: the next replay overwrites
        the static ones."""
        self.images.copy_(images)
        self.image_hw.copy_(image_hw)
        for name, graph in self.graphs:
            graph.replay()
            if mark:
                mark(name)
        return ServeDetections(*(t.clone() for t in self.out))


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

    On the GPU with the model in eval mode, ``__call__`` runs each input
    shape (``images``' shape, dtype and device) eagerly the first time,
    which fills the lazy caches (anchors, the ViT's resize matrices, cuBLAS
    and cuDNN state); the second time it captures the stages as CUDA graphs
    and from then on replays them, for at most ``GRAPH_SHAPES`` shapes.
    Graphs read the parameters where they lie, so weights loaded in place
    (``load_state_dict``) are used by the next replay; parameters or
    buffers that move drop every graph. ``post_cfg`` is read at capture.
    The tracer counts the calls of each kind: "predict.eager",
    "predict.graph.capture", "predict.graph.replay". A replay runs the
    kernels its capture recorded without calling their wrappers, so the
    ``kernel.*`` counters count the eager and the capturing calls only.
    """

    def __init__(self, cfg, device: Optional[Union[str, torch.device]] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                 post_cfg: Optional[PostprocessConfig] = None):
        super().__init__(cfg, device, state_dict, seed)
        if post_cfg is None:
            from ..engine.train_loop import class_id_table

            post_cfg = PostprocessConfig.from_cfg(cfg, cfg.OPENDET_BENCHMARK, class_id_table(cfg))
        self.post_cfg = post_cfg
        self._graphs: Dict[tuple, _StageGraphs] = {}
        self._seen: set = set()  # shapes run once eagerly
        # every module's parameters and buffers by name, read for their addresses on each call
        self._tensor_dicts = [d for m in self.model.modules() for d in (m._parameters, m._buffers)]
        self._graph_addresses: List[int] = []  # those addresses when the graphs were captured
        self._pool = self._stream = None

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
        ``inference_forward``), on the graph path as on the eager one."""
        with tracing.span("predict"):
            kind, out = self._graphed(images, image_hw, mark)
            if kind == "predict.eager":
                out = self.cascade(self.raw(images, image_hw, mark))
                if mark:
                    mark("cascade")
        tracing.count(kind)
        return out

    @torch.inference_mode()
    def _graphed(self, images: torch.Tensor, image_hw: torch.Tensor,
                 mark: Mark) -> Tuple[str, Optional[ServeDetections]]:
        """(kind of call, its outputs when a graph gave them; None when the
        call is to run eagerly)."""
        if self.device.type != "cuda" or self.model.training:
            return "predict.eager", None
        addresses = [t.data_ptr() for t in itertools.chain.from_iterable(map(dict.values, self._tensor_dicts))
                     if t is not None]
        if addresses != self._graph_addresses:  # moved or replaced: the graphs would read stale memory
            self._graphs.clear()
            self._seen.clear()
            self._graph_addresses, self._pool = addresses, None
        key = (tuple(images.shape), images.dtype, images.device)
        graphs = self._graphs.get(key)
        if graphs is not None:
            return "predict.graph.replay", graphs.replay(images, image_hw, mark)
        if key not in self._seen or len(self._graphs) >= GRAPH_SHAPES:
            self._seen.add(key)
            return "predict.eager", None
        if self._pool is None:
            self._pool, self._stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(self.device)
        anchors, level_sizes = self._bucket_anchors(tuple(images.shape[1:3]))
        stages = inference_stages(self.model, anchors, level_sizes)
        stages.append(("cascade", lambda raw: (serve_cascade(raw, self.post_cfg),)))
        with torch.cuda.device(self.device):
            graphs = self._graphs[key] = _StageGraphs(stages, images, image_hw, self.device, self._pool, self._stream)
        return "predict.graph.capture", graphs.replay(images, image_hw, mark)


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
