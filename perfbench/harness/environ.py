"""The process's environment, set before PyTorch is imported.

Every build and kernel cache at a fixed path inside the checkout (the
port's own CUDA libraries build into ``openset_rcnn_tpu_torch/_build/``),
no flax through ``transformers``, and one thread for each CPU math library
(OpenMP, and so PyTorch's intra-op pool, MKL, OpenBLAS): the host-fed loops
run on the program's own threads (the loaders' and the main thread), and an
idle math pool that spins between small CPU operations only takes cores from
them, and more on some runs than on others.
"""
import os
from pathlib import Path

MATH_THREADS = "1"


def prepare(bench: Path) -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(bench / ".cache" / sub)
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = MATH_THREADS
