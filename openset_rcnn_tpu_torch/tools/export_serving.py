"""Export the serving program (forward + fused cascade) with ``torch.export``:

    python -m openset_rcnn_tpu_torch.tools.export_serving \\
        --config-file configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml \\
        --batch 8 --out serving.pt2 [--platform cpu|gpu] [--split] \\
        [MODEL.WEIGHTS weights.pth ...]

Port of ``tools/export_serving.py:48-205``. The program holds the weights
and the bucket's anchors (``TPU.TEST_BUCKET``) and takes a fixed batch:
``(images (B, H, W, 3) f32 raw BGR pixels padded to the bucket, image_hw
(B, 2) f32)`` -> the ``ServeDetections`` fields as a flat tuple ``(boxes,
scores, classes, valid, known_overflow)`` (``ServeDetections(*outputs)``
names them). RoIAlign (K1) and the greedy NMS keep mask (K4) are the custom
operators ``openset_rcnn::roi_align_fwd`` and ``openset_rcnn::nms_keep``,
one node each in the graph, so the loaded program launches the CUDA kernels
on the GPU (and runs their plain versions on the CPU), counted as eager
code counts them. ``--platform`` picks the device the program is exported
for (default: the GPU; without one the tool raises unless given ``cpu``).

``--split`` writes two chained programs instead, as the JAX tool does:
``<out>.fwd`` (images -> the eight ``RawDetections`` fields) and
``<out>.casc`` (those fields -> the five outputs).

Consumer side (an exported program records no process-wide numerics flags:
run it under ``entry_numerics``, or an f32 config computes in TF32 on the
card):

    import torch
    import openset_rcnn_tpu_torch.ops  # registers the two custom operators
    from openset_rcnn_tpu_torch.device import entry_numerics
    from openset_rcnn_tpu_torch.tools import export_serving

    serve = export_serving.load("serving.pt2")
    with torch.inference_mode(), entry_numerics():
        boxes, scores, classes, valid, known_overflow = serve(images, image_hw)
    # --split: casc(*fwd(images, image_hw)) with
    # fwd = export_serving.load("serving.pt2.fwd"), casc likewise

where ``export_serving.load(path)`` is ``torch.export.load(open(path,
"rb")).module()`` (a file object: ``torch.export`` takes a path only if it
ends in ``.pt2``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..evaluation.postprocess import PostprocessConfig
from ..models.detector import OpensetRCNN, inference_forward
from ..structures import RawDetections

PLATFORMS = {"cpu": "cpu", "gpu": None}  # --platform -> device (None: the GPU, or raise)
RAW_FIELDS = tuple(f.name for f in dataclasses.fields(RawDetections))


class ServingForward(nn.Module):
    """``inference_forward`` with the bucket's anchors as a buffer: the
    eight ``RawDetections`` fields as a flat tuple."""

    def __init__(self, model: OpensetRCNN, anchors: torch.Tensor, level_sizes: Sequence[int]):
        super().__init__()
        self.model = model
        self.register_buffer("anchors", anchors)
        self.level_sizes = list(level_sizes)

    def forward(self, images: torch.Tensor, image_hw: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        raw = inference_forward(self.model, images, image_hw, self.anchors, self.level_sizes)
        return tuple(getattr(raw, name) for name in RAW_FIELDS)


class ServingCascade(nn.Module):
    """The fused cascade (``evaluation.inference.serve_cascade``) over the
    eight ``RawDetections`` fields: the five ``ServeDetections`` fields."""

    def __init__(self, post_cfg: PostprocessConfig):
        super().__init__()
        self.post_cfg = post_cfg

    def forward(self, *raw: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        from ..evaluation.inference import serve_cascade

        return tuple(serve_cascade(RawDetections(*raw), self.post_cfg))


class Serving(nn.Module):
    """Forward and cascade in one program."""

    def __init__(self, fwd: ServingForward, casc: ServingCascade):
        super().__init__()
        self.fwd, self.casc = fwd, casc

    def forward(self, images: torch.Tensor, image_hw: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.casc(*self.fwd(images, image_hw))


def build_split_serving_fns(cfg, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                            device: Optional[Union[str, torch.device]] = None) -> Tuple[ServingForward, ServingCascade]:
    """(forward half, cascade half) of the serving program for ``cfg`` on
    ``device`` (the GPU unless given), with ``state_dict``, else
    ``MODEL.WEIGHTS``, else the seeded random init; ``casc(*fwd(images,
    image_hw))`` is the single program. Class table as ``tools.predict``'s."""
    from ..engine.checkpoint import load_weights_file
    from ..evaluation.inference import Predictor
    from .predict import serving_classes

    post_cfg = PostprocessConfig.from_cfg(cfg, cfg.OPENDET_BENCHMARK, serving_classes(cfg)[1])
    predictor = Predictor(cfg, device, state_dict, seed=max(cfg.SEED, 0), post_cfg=post_cfg)
    if state_dict is None and cfg.MODEL.WEIGHTS:
        load_weights_file(cfg.MODEL.WEIGHTS, predictor.model)
    anchors, level_sizes = predictor._bucket_anchors(tuple(cfg.TPU.TEST_BUCKET))
    fwd = ServingForward(predictor.model, anchors, level_sizes).eval().requires_grad_(False)
    return fwd, ServingCascade(post_cfg).eval()


def build_serving_fn(cfg, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                     device: Optional[Union[str, torch.device]] = None) -> Serving:
    """The single serving program's module (see ``build_split_serving_fns``)."""
    return Serving(*build_split_serving_fns(cfg, state_dict, device))


def example_inputs(cfg, batch: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    bh, bw = cfg.TPU.TEST_BUCKET
    return (torch.zeros((batch, bh, bw, 3), dtype=torch.float32, device=device),
            torch.zeros((batch, 2), dtype=torch.float32, device=device))


def export(module: nn.Module, args: Tuple[torch.Tensor, ...]) -> torch.export.ExportedProgram:
    with torch.no_grad():
        return torch.export.export(module, args)


def output_examples(program: torch.export.ExportedProgram) -> Tuple[torch.Tensor, ...]:
    """Zero tensors of the shapes and dtypes of ``program``'s outputs."""
    outputs = next(iter(program.graph.find_nodes(op="output"))).args[0]
    return tuple(torch.zeros(n.meta["val"].shape, dtype=n.meta["val"].dtype, device=n.meta["val"].device)
                 for n in outputs)


def load(path: str) -> nn.Module:
    """The module of the program saved at ``path`` (any file name)."""
    with open(path, "rb") as f:
        return torch.export.load(f).module()


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="export the serving program with torch.export (PyTorch port)")
    p.add_argument("--config-file", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--out", required=True)
    p.add_argument("--platform", choices=tuple(PLATFORMS), default="gpu", help="device to export for")
    p.add_argument("--split", action="store_true",
                   help="export the chained forward + cascade pair (<out>.fwd + <out>.casc)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p


def main(argv: Optional[Sequence[str]] = None) -> Sequence[str]:
    """Export as the flags say; returns the paths written."""
    args = get_parser().parse_args(argv)

    from ..config import get_default_cfg
    from ..data import register_builtin_datasets

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    register_builtin_datasets()

    fwd, casc = build_split_serving_fns(cfg, device=PLATFORMS[args.platform])
    inputs = example_inputs(cfg, args.batch, fwd.anchors.device)
    if args.split:
        e_fwd = export(fwd, inputs)
        programs = {args.out + ".fwd": e_fwd, args.out + ".casc": export(casc, output_examples(e_fwd))}
    else:
        if cfg.TEST.DETECTIONS_PER_IMAGE < 1000:
            # the JAX tool's warning (its single program crashed the TPU
            # worker at the yacs default 100); kept so both tools say the same
            print(f"WARNING: single-program export with TEST.DETECTIONS_PER_IMAGE={cfg.TEST.DETECTIONS_PER_IMAGE} "
                  "< 1000 is OFF the validated envelope (known TPU worker crash at 100 in the JAX package); "
                  "use --split or DETECTIONS_PER_IMAGE 1000", file=sys.stderr)
        programs = {args.out: export(Serving(fwd, casc), inputs)}
    for path, program in programs.items():
        program.example_inputs = None  # the zero inputs above would add a batch of pixels to the file
        with open(path, "wb") as f:  # a file object: torch.export names no suffix but .pt2 otherwise
            torch.export.save(program, f)
        print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB, device {fwd.anchors.device}, "
              f"input ({args.batch}, {cfg.TPU.TEST_BUCKET[0]}, {cfg.TPU.TEST_BUCKET[1]}, 3))")
    if args.split:
        print(f"chain: casc(*fwd(images ({args.batch}, {cfg.TPU.TEST_BUCKET[0]}, {cfg.TPU.TEST_BUCKET[1]}, 3), "
              "image_hw))")
    return list(programs)


if __name__ == "__main__":
    main()
