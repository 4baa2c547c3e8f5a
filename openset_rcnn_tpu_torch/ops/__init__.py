"""Box ops, anchors, top-k, and the two kernel-backed ops (RoIAlign, NMS).

Import from the submodules (``ops.roi_align``, ``ops.nms``, ...). Importing
this package registers the custom operators ``openset_rcnn::roi_align_fwd``
and ``openset_rcnn::nms_keep`` (K1 and K4), which a program exported by
``tools/export_serving.py`` calls: import it before ``torch.export.load``.
"""
from . import nms, roi_align  # noqa: F401 (registers the custom operators)
