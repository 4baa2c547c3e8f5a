"""Finding a cell's files by name.

Everything that belongs to one configuration, traffic mix, cell, entry loop
or per-layer metric sits in a file of its own under ``perfbench/``, found by
the name that ``BENCHMARK.json`` or a cell's file gives:

* ``configs/<config>.json``: the configuration as run (``cfg``), its source,
  the keys changed from it, the precision and the weight recipe;
* ``workloads/<cell>.json``: the configuration, the traffic mix, the entry
  loop, the end-to-end and per-layer metrics, the numbers compared for
  ``correct`` with their limits, and why the cell exists;
* ``traffic/<mix>.json``: the parameters that ``harness/traffic.py`` reads;
* ``entries/<entry>.py``: a window loop, with ``run(ctx)``;
* ``metrics/<name>.py``, or ``metrics/<family>.py`` for every metric named
  ``<family>.<suffix>``: a reader with ``read(trace, suffix)``;
* ``reference/backbones/<trunk>.py`` and ``counts/backbones/<trunk>.py``,
  for the ``MODEL.BACKBONE.NAME`` of a configuration: the reference's trunk
  and its operation counts.

A later change adds a configuration, a mix, a cell, a metric or a trunk by
adding files; no file here has to change.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MODULE_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


class SpecError(ValueError):
    """A cell, configuration, mix, entry or metric that is missing or
    malformed."""


def _json(kind: str, name: str) -> Dict[str, Any]:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise SpecError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)} is missing)")
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> Dict[str, Any]:
    """The cell's file, with its configuration and traffic mix loaded under
    ``config_spec`` and ``traffic_spec``."""
    cell = _json("workloads", name)
    for key in ("config", "traffic", "entry", "end_to_end", "per_layer", "compare"):
        if key not in cell:
            raise SpecError(f"workloads/{name}.json has no {key!r}")
    cell["name"] = name
    cell["config_spec"] = config(cell["config"])
    cell["traffic_spec"] = traffic(cell["traffic"])
    return cell


def config(name: str) -> Dict[str, Any]:
    spec = _json("configs", name)
    for key in ("cfg", "precision", "weights", "source", "reduced"):
        if key not in spec:
            raise SpecError(f"configs/{name}.json has no {key!r}")
    return spec


def traffic(name: str) -> Dict[str, Any]:
    spec = _json("traffic", name)
    if "kind" not in spec:
        raise SpecError(f"traffic/{name}.json has no 'kind'")
    spec["name"] = name
    return spec


def _module(path: Path, qualname: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(qualname, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(name: str) -> ModuleType:
    path = BENCH / "entries" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no entry loop named {name!r} ({path.relative_to(ROOT)} is missing)")
    return _module(path, f"perfbench.entries.{name}")


def metric_reader(name: str) -> ModuleType:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<family>.py`` for ``<family>.<suffix>``."""
    for stem in (name, name.split(".", 1)[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.is_file():
            return _module(path, f"perfbench.metrics.{stem.replace('.', '_')}")
    raise SpecError(f"no reader for metric {name!r} (metrics/{name}.py or metrics/{name.split('.', 1)[0]}.py)")


def backbone(part: str, name: str) -> ModuleType:
    """The trunk that ``MODEL.BACKBONE.NAME`` ``name`` names, as ``part``
    (``reference`` or ``counts``) has it: ``<part>/backbones/<name>.py``."""
    path = BENCH / part / "backbones" / f"{name}.py"
    if not MODULE_NAME.fullmatch(name) or not path.is_file():
        raise SpecError(f"no {part} backbone named {name!r} ({path.relative_to(ROOT)} is missing)")
    return _module(path, f"perfbench.{part}.backbones.{name}")


def benchmark() -> Dict[str, Any]:
    """``BENCHMARK.json`` at the root of the checkout."""
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError("BENCHMARK.json is missing")
    with open(path) as f:
        return json.load(f)
