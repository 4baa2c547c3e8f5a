"""The benchmark's plain reference of the detector.

Plain PyTorch and NumPy, in the configuration's precision, and no kernel: a frozen copy of the
modules of ``openset_rcnn_tpu_torch`` that the benchmark's cells run, taken
at the commit that defined the benchmark, with the kernel wrappers replaced
by their plain versions (``ops/roi_align.py``, ``ops/nms.py``,
``ops/iou_match.py``), the RoIAlign backward left to autograd over the plain
gather, the tensor-parallel box head, the Swin backbone, the native NMS and
the multi-process merges removed. It imports nothing of the program, so a
later change to the program cannot move it. The modules keep their
source's docstrings (each says what it ports); ``model.py`` reads a
configuration file's ``cfg``, builds the detector and runs its steps. The
trunk is the one ``backbones/<MODEL.BACKBONE.NAME>.py`` builds, so a new
trunk is a new file there.
"""
