"""Operation counts of the trunks, one file for each ``MODEL.BACKBONE.NAME``.

``<name>.py`` has ``layers(cfg, h, w) -> List[Layer]``: every convolution
and matrix product of the trunk and its pyramid for one image on an ``h`` x
``w`` bucket, as ``counts/model.py`` defines a layer.
"""
