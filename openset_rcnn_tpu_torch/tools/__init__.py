"""The port's command-line tools, run with ``python -m``:

  * ``openset_rcnn_tpu_torch.tools.predict``: open-set detections of image
    files as JSON (and overlays);
  * ``openset_rcnn_tpu_torch.tools.export_serving``: the serving program as a
    ``torch.export`` artifact that launches the CUDA kernels when loaded;
  * ``openset_rcnn_tpu_torch.tools.convert_checkpoint``: a d2, caffe2, Swin
    or ViT checkpoint as a port checkpoint (``.pt``) for ``MODEL.WEIGHTS``.

Counterparts of the repository's ``tools/*.py`` for the JAX package.
"""
