"""Box ops, anchors, top-k, and the kernel-backed ops (RoIAlign, NMS, FrozenBN,
MViT's attention pooling).

Import from the submodules (``ops.roi_align``, ``ops.nms``, ...). Importing
this package registers the custom operators ``openset_rcnn::roi_align_fwd``
and ``openset_rcnn::nms_keep`` (K1 and K4) and ``openset_rcnn::frozen_bn_act``
(the ResNet trunk's FrozenBN, residual and ReLU), which a program exported
by ``tools/export_serving.py`` calls: import it before ``torch.export.load``;
and ``openset_rcnn::mvit_pool_norm`` (MViT's pooling of q, k and v).
"""
from . import frozen_bn, mvit_pool, nms, roi_align  # noqa: F401 (registers the custom operators)
