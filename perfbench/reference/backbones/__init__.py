"""The reference's trunks, one file for each ``MODEL.BACKBONE.NAME``.

``<name>.py`` has ``build(cfg, dtype) -> (trunk, fpn_in_channels)``: the
trunk of the configuration ``cfg`` (attribute access, as ``model.Cfg``) in
compute dtype ``dtype``, and the widths of the ``res2``..``res5`` maps it
emits for the FPN, or None where it emits ``p2``..``p6`` itself. The trunk
has ``reset_parameters(generator)``; where it drops residual branches in
training it takes ``drop_path`` in its forward and lists ``branch_rates``.
Its leaves carry the program's names, so one state dict loads into both.
"""
