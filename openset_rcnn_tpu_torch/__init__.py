"""openset_rcnn_tpu_torch: the PyTorch/CUDA port of ``openset_rcnn_tpu``.

The JAX package beside it stays the reference. This package imports neither
JAX nor any module of ``openset_rcnn_tpu``: what it needs from there it keeps
as its own copy, and each copy names its source file.

What runs here (every config of ``configs/``, f32 or bf16; the backbone is
ResNet + FPN, Swin-T + FPN or ViT-B with its simple pyramid):
  * serving: preprocess -> backbone (e.g. ResNet-50 with FrozenBN) -> P2-P6
    -> CF-RPN head -> per-level top-k proposals -> RoIAlign (CUDA kernel) ->
    box/IoU/PLN/classifier heads -> raw detections -> fused open-set cascade
    with greedy NMS (CUDA kernel): ``evaluation.inference.Predictor``;
    proposals only: ``ProposalPredictor``;
  * training: the SGD step with the fused IoU+matcher and the RoIAlign
    backward (CUDA kernels): ``engine.train_state.Trainer``;
  * evaluation: ``engine.train_loop.do_test`` over a dataset of the catalog
    (``data``: VOC-XML and COCO-json readers, the builtin VOC-COCO and
    GraspNet-OS registrations, the test transform, ``EvalLoader`` and a
    pinned-memory device prefetch) -> ``evaluation.testing.
    inference_on_dataset`` (the fused cascade, or the exact host cascade of
    ``evaluation.postprocess``) -> the open-set VOC and COCO evaluators, or
    the proposal AR of ``eval_type="proposals"``.

Entry points run on the GPU unless the caller passes ``device="cpu"``. On the
CPU every kernel wrapper runs its plain PyTorch version. Each entry point
sets its own numerics (``device.entry_numerics``).
"""

__version__ = "0.1.0"
