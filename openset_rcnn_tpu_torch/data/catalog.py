"""Dataset + metadata catalogs.

Copy of ``openset_rcnn_tpu/data/catalog.py``, kept in the port so
that it imports nothing of the JAX package.

TPU-agnostic host-side registries equivalent to d2's ``DatasetCatalog`` /
``MetadataCatalog`` (the reference registers datasets into them as an import
side effect, data/custom.py:48-52; SURVEY.md §1 L2).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, fn: Callable[[], List[dict]]):
        if name in self._registry:
            raise KeyError(f"dataset {name} already registered")
        self._registry[name] = fn

    def get(self, name: str) -> List[dict]:
        if name not in self._registry:
            raise KeyError(f"dataset {name} not registered; known: {sorted(self._registry)}")
        return self._registry[name]()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str):
        self._registry.pop(name, None)


class _Metadata(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def set(self, **kwargs):
        self.update(kwargs)
        return self


class _MetadataCatalog:
    def __init__(self):
        self._registry: Dict[str, _Metadata] = {}

    def get(self, name: str) -> _Metadata:
        if name not in self._registry:
            self._registry[name] = _Metadata()
        return self._registry[name]


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
