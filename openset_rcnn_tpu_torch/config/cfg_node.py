"""Hierarchical config node.

Copy of ``openset_rcnn_tpu/config/cfg_node.py``: the port carries its own copy
so that it imports nothing of the JAX package.

A minimal, dependency-free equivalent of the yacs ``CfgNode`` the reference
builds on (reference: openset_rcnn/config/config.py, detectron2 yacs configs).
Supports:
  * attribute + item access,
  * ``_BASE_`` YAML inheritance (configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml:1),
  * ``merge_from_list([KEY, VALUE, ...])`` CLI override grammar (train.py:253-258),
  * ``freeze()`` / ``clone()``.
"""
from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List

import yaml


class CfgNode(dict):
    """A dict with attribute access, freezing, and YAML merging."""

    _FROZEN = "__frozen__"

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def __setitem__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        super().__setitem__(name, value)

    # -- freezing ----------------------------------------------------------
    def is_frozen(self) -> bool:
        return getattr(self, CfgNode._FROZEN)

    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self).defrost()

    # -- merging -----------------------------------------------------------
    def merge_from_other(self, other: Dict[str, Any]) -> None:
        for k, v in other.items():
            if isinstance(v, dict):
                if k not in self or not isinstance(self[k], CfgNode):
                    self[k] = CfgNode()
                self[k].merge_from_other(v)
            else:
                self[k] = _coerce(v, self.get(k))

    def merge_from_file(self, path: str, allow_unsafe: bool = False) -> None:
        data = _load_yaml_with_base(path)
        self.merge_from_other(data)

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f"Override list must be key-value pairs, got {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = CfgNode()
                node = node[p]
            node[parts[-1]] = _coerce(_parse_literal(value), node.get(parts[-1]))

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()}

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True)


def _parse_literal(s: Any) -> Any:
    if not isinstance(s, str):
        return s
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _coerce(value: Any, old: Any) -> Any:
    """Coerce value toward the type of the existing entry (tuple/list interop)."""
    if old is None:
        return value
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    return value


def _load_yaml_with_base(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    base_key = "_BASE_"
    if base_key in data:
        base_path = data.pop(base_key)
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(path), base_path)
        base = _load_yaml_with_base(base_path)
        _deep_update(base, data)
        return base
    return data


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
