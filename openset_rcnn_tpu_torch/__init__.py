"""openset_rcnn_tpu_torch: the PyTorch/CUDA port of ``openset_rcnn_tpu``.

The JAX package beside it stays the reference. This package imports neither
JAX nor any module of ``openset_rcnn_tpu``: what it needs from there it keeps
as its own copy, and each copy names its source file.

What runs here (the serving path, R50-FPN):
  preprocess -> ResNet-50 (FrozenBN) -> FPN P2-P6 -> CF-RPN head ->
  per-level top-k proposals -> RoIAlign (CUDA kernel) -> box/IoU/PLN/classifier
  heads -> raw detections -> fused open-set cascade with greedy NMS (CUDA
  kernel). The entry point is ``evaluation.inference.Predictor``.

Entry points run on the GPU unless the caller passes ``device="cpu"``. On the
CPU every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
