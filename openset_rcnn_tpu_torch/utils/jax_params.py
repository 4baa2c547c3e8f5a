"""JAX parameters -> the port's ``state_dict``.

The input is the nested dict of ``module.init(...)["params"]`` of the JAX
``OpensetRCNNModule`` after ``jax.tree.map(np.asarray, ...)``: plain numpy, so
this module needs no JAX. It inverts the layout helpers of
``openset_rcnn_tpu/utils/torch_weights.py:30-47``:

* conv kernels HWIO -> OIHW;
* Dense kernels (I, O) -> (O, I); the first box-head FC needs no row
  permutation because the port pools RoIs as (R, 7, 7, C), the JAX order;
* FrozenBN ``scale/bias/mean/var`` -> buffers of the same names;
* the PLN ``representatives`` as they are.

Module names of the port follow the JAX tree, so a key maps by joining its
path with "." and renaming ``kernel`` to ``weight``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _convert(key: str, value: np.ndarray):
    *path, leaf = key.split(".")
    if leaf == "kernel":
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif value.ndim == 2:
            value = value.T  # (I, O) -> (O, I)
        else:
            raise KeyError(f"{key}: no mapping for a kernel of shape {value.shape}")
        leaf = "weight"
    elif leaf not in ("bias", "scale", "mean", "var", "representatives"):
        raise KeyError(f"{key}: no mapping for this parameter")
    return ".".join([*path, leaf]), torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))


def state_dict_from_jax(params: Mapping[str, Any], expected_keys: Iterable[str]) -> Dict[str, torch.Tensor]:
    """The port's state_dict for JAX ``params``.

    ``expected_keys`` are the keys of the port model's ``state_dict()``. Raises
    KeyError on a parameter with no mapping, on a parameter that maps to no
    key of the port, and on a key of the port that no parameter fills.
    """
    out = dict(_convert(k, v) for k, v in _flatten(params).items())
    expected = set(expected_keys)
    unexpected = sorted(set(out) - expected)
    missing = sorted(expected - set(out))
    if unexpected or missing:
        raise KeyError(f"JAX params do not match the port: missing {missing[:8]}, unexpected {unexpected[:8]}")
    return out
