"""One run of one cell: the context the entry loops share, the seeds, the
program's configuration and weights, the result line.

``main(argv)`` is ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. It refuses to run without as many CUDA cards
as the cell asks for (there is no CPU fallback), runs the cell's entry loop,
checks the outputs against the reference, and prints the result as the last
line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: every number compared with its limit. The same numbers and
limits are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from . import specs

FORBIDDEN = ("jax", "jaxlib", "flax", "openset_rcnn_tpu")


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclass
class Check:
    """One number compared for ``correct``: within its limit when ``value <=
    limit`` (a gap), or ``value >= limit`` where lower is worse (a share
    kept, ``at_least``)."""

    name: str
    value: float
    limit: float
    at_least: bool = False

    @property
    def ok(self) -> bool:
        if not math.isfinite(self.value):
            return False
        return self.value >= self.limit if self.at_least else self.value <= self.limit


@dataclass
class Run:
    """A run's context and what its entry loop reports."""

    cell: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    t_start: float = 0.0
    workdir: str = ""
    # filled by the entry loop
    setup_s: float = 0.0
    e2e: Dict[str, float] = field(default_factory=dict)
    per_layer_inputs: Dict[str, Any] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    profile: Optional[dict] = None
    checks: List[Check] = field(default_factory=list)
    notes: Dict[str, Any] = field(default_factory=dict)

    @property
    def config(self) -> Dict[str, Any]:
        return self.cell["config_spec"]

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell["traffic_spec"]

    def sub_seed(self, what: str, bits: int = 31) -> int:
        """A seed for one use (``what``) drawn from the run's seed."""
        words = np.random.SeedSequence([self.seed, *what.encode()]).generate_state(2, dtype=np.uint32)
        return int((int(words[0]) << 32 | int(words[1])) % (1 << bits))

    def compare(self, numbers: Dict[str, Any]) -> None:
        """Hold every number the cell's file compares to its limit; keep
        the rest of ``numbers`` as readings beside them."""
        for name, spec in self.cell["compare"].items():
            self.checks.append(Check(name, float(numbers[name]), float(spec["limit"]), bool(spec.get("at_least"))))
        self.notes["readings"] = {k: v for k, v in numbers.items() if k not in self.cell["compare"]}

    def mark_setup_done(self) -> None:
        sync()
        self.setup_s = time.perf_counter() - self.t_start


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def peak_memory(device) -> int:
    """The card's peak of allocated bytes in this process (0 off the card)."""
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release() -> None:
    """Free what the program left on the card before the reference runs."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def program_cfg(config: Dict[str, Any]):
    """The program's CfgNode of a configuration file: the defaults with
    every key of the file's ``cfg`` set, and no output directory (the run
    writes no checkpoints, metrics or detection files)."""
    from openset_rcnn_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_other(json.loads(json.dumps(config["cfg"])))
    cfg.OUTPUT_DIR = ""
    return cfg


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device is available: the benchmark measures the card and has no CPU path")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards; {torch.cuda.device_count()} are visible")


def device_info(r: Run) -> Dict[str, Any]:
    import torch

    on_card = r.device is not None and r.device.type == "cuda"
    info = {"platform": "gpu" if on_card else r.device.type if r.device is not None else "none",
            "kind": torch.cuda.get_device_name(r.device) if on_card else "none",
            "count": int(r.cell.get("chips", 1)), "memory_peak_bytes": int(r.memory_peak_bytes)}
    if r.profile is not None:
        info["busy_s"] = r.profile["busy_s"]
        info["window_s"] = r.profile["window_s"]
    return info


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def units() -> Dict[str, str]:
    bench = specs.benchmark()
    return {m["name"]: m["unit"] for m in bench.get("end_to_end", []) + bench.get("per_layer", [])}


def per_layer(r: Run) -> Dict[str, float]:
    """The cell's per-layer metrics that their readers found something to
    read for; a reader that finds nothing returns None and its metric is
    left out."""
    out = {}
    for name in r.cell["per_layer"]:
        suffix = name.split(".", 1)[1] if "." in name else ""
        value = specs.metric_reader(name).read(r, suffix)
        if value is not None:
            out[name] = float(value)
    return out


def result_line(r: Run) -> Dict[str, Any]:
    unit = units()
    if r.trace:
        values = per_layer(r)
    else:
        values = dict(r.e2e)
        values["setup_s"] = r.setup_s
    line: Dict[str, Any] = {
        "correct": bool(r.checks) and all(c.ok for c in r.checks),
        "attempted": int(r.attempted),
        "failed": int(r.failed),
        "metrics": {k: {"value": v, "unit": unit.get(k, "")} for k, v in values.items()},
        "device": device_info(r),
    }
    if r.trace and r.profile is not None:
        line["breakdown"] = {"device_ops": r.profile["device_ops"], "idle_gaps": r.profile["idle_gaps"]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit, **({"at_least": True} if c.at_least else {})}
                      for c in r.checks}
    return line


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def drive(r: Run, entry, control: Optional[str] = None) -> None:
    """One run of the entry loop ``entry``: its set-up (``setup_s``), its
    window, the program freed, then its numbers held to the cell's limits.
    ``control`` (a precision) puts the reference in that precision in the
    program's place for the comparison (``calibrate.py``, the tests)."""
    s = entry.setup(r)
    r.mark_setup_done()
    entry.window(r, s)
    entry.free(s)
    r.compare(entry.numbers(r, s, control))


def execute(r: Run, entry, control: Optional[str] = None) -> Dict[str, Any]:
    """``drive`` in a temporary directory of its own under ``TMPDIR``,
    removed afterwards; the result line."""
    r.workdir = tempfile.mkdtemp(prefix="perfbench-")
    try:
        drive(r, entry, control)
    finally:
        shutil.rmtree(r.workdir, ignore_errors=True)
    return result_line(r)


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    cell = specs.workload(args.workload)
    try:
        require_cards(int(cell.get("chips", 1)))
    except NoDevice as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch

    torch.cuda.set_device(0)
    r = Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
            device=torch.device("cuda", 0), t_start=t_start)
    line = execute(r, specs.entry(cell["entry"]))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {found}: nothing the benchmark runs may import JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    limit = power_limit()
    if limit:
        print(f"perfbench: card {limit}", file=sys.stderr)
    for name, v in r.notes.items():
        print(f"perfbench: {name} {json.dumps(v)}", file=sys.stderr)
    for c in r.checks:
        bound = "at least" if c.at_least else "at most"
        print(f"check {c.name}: {c.value!r} ({bound} {c.limit!r}){'' if c.ok else ' FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
