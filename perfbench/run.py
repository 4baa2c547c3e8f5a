"""The benchmark of openset_rcnn_tpu_torch on one H100.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. See ``perfbench/README.md``.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if sys.path and Path(sys.path[0]).resolve() == BENCH:
    sys.path.pop(0)  # perfbench's directories are not top-level modules
sys.path.insert(0, str(ROOT))

from perfbench.harness import environ  # noqa: E402

environ.prepare(BENCH)

from perfbench.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
