"""The readings that a cell's limits are set from, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3] [--seconds S]
        [--images-per-pass N] [--set KEY=VALUE ...]

For every seed of ``--seeds`` the cell's run goes as a benchmark run goes
(``core.drive``: set-up, a window of ``--seconds``, ``0`` for one step, pass
or frame, the comparison) and the numbers compared, with their limits and
the readings beside them, are printed as one JSON line. For every seed of
``--control-seeds`` the control stands in for the program in the
comparison: the reference in the nearest precision below the
configuration's (``precision.control`` of its file: fp8 under bf16, TF32
under f32). ``--set`` changes a key of the configuration's ``cfg`` for the
program and the reference alike (``TPU.ROI_ALIGN_BWD=pallas``: a look at
one cause). The benchmark's own runs never run the control. Card only, as
``run.py``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == BENCH:
    sys.path.pop(0)
sys.path.insert(0, str(BENCH.parent))

from perfbench.harness import environ  # noqa: E402

environ.prepare(BENCH)

from perfbench.harness import core, specs  # noqa: E402


def readings(cell, seed, seconds, control, device):
    """The numbers of one seed: the program's, or with ``control`` the
    control's in its place."""
    import torch

    r = core.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=device, t_start=time.perf_counter())
    try:
        core.execute(r, specs.entry(cell["entry"]), r.config["precision"]["control"] if control else None)
    finally:
        core.release()
        torch.cuda.reset_peak_memory_stats()
    out = {c.name: c.value for c in r.checks}
    out["correct"] = all(c.ok for c in r.checks)
    out.update(r.notes.pop("readings", {}))
    out.update(r.notes)
    return out


def override(cfg, assignment):
    """``KEY=VALUE`` (dotted key, the value as JSON or else a string) set in
    ``cfg``."""
    key, _, value = assignment.partition("=")
    try:
        value = json.loads(value)
    except ValueError:
        pass
    *path, last = key.split(".")
    for k in path:
        cfg = cfg[k]
    if last not in cfg:
        raise KeyError(f"{key} is not a key of the configuration")
    cfg[last] = value


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--images-per-pass", type=int, default=0,
                   help="an evaluation cell's pass for the readings (its detections do not depend on the pass length)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = p.parse_args()
    cell = specs.workload(args.workload)
    for assignment in args.set:
        override(cell["config_spec"]["cfg"], assignment)
    if args.images_per_pass:
        cell["images_per_pass"] = args.images_per_pass
    core.require_cards(int(cell.get("chips", 1)))
    import torch

    device = torch.device("cuda", 0)
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in [int(x) for x in seeds.split(",") if x]:
            t = time.perf_counter()
            out = readings(cell, seed, args.seconds, kind == "control", device)
            print(json.dumps({"workload": args.workload, "side": kind, "seed": seed,
                              "seconds": round(time.perf_counter() - t, 1), **out}), flush=True)
    found = core.forbidden_modules()
    if found:
        print(f"calibrate: the process loaded {found}", file=sys.stderr)
        return 3
    print(f"calibrate: card {core.power_limit()}; {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
