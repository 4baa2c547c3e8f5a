from .cfg_node import CfgNode
from .defaults import get_default_cfg, add_openset_rcnn_config

__all__ = ["CfgNode", "get_default_cfg", "add_openset_rcnn_config"]
