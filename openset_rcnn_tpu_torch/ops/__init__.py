"""Box ops, anchors, top-k, and the two kernel-backed ops (RoIAlign, NMS).

Import from the submodules (``ops.roi_align``, ``ops.nms``, ...).
"""
