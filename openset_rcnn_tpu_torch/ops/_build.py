"""Build and load the port's CUDA kernels and its host code.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with ``nvcc``
for ``sm_90a`` (Hopper) into its own shared library under ``_build/`` on
first use and loaded with ``ctypes``; nothing includes PyTorch's headers, so
a build takes seconds. A ``csrc/<name>.cpp`` (host code, such as the bilinear
resize) is built the same way by the host compiler (``$CXX``, else ``g++``,
else ``c++``) for the machine it runs on. The library's file name carries a
hash of its source, of every header it includes from ``csrc/`` (``#include
"<header>"``, and theirs in turn) and of the flags, so an edited source or
header is rebuilt and never served stale.

There is no fast math: ``--fmad=false`` keeps every multiply and add rounded
on its own, as the plain PyTorch versions compute them, so the NMS keep
masks and the IoU matcher's outputs match exactly; ``-ffp-contract=off``
does the same for host code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("roi_align_fwd", "roi_align_bwd", "iou_match", "nms_keep", "launch_floor")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


class CompilerMissing(RuntimeError):
    """No host compiler: a ``.cpp`` library cannot be built here."""


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise CompilerMissing("no host compiler ($CXX, g++ or c++) to build the host libraries")
    return cxx


def source(name: str) -> Path:
    """``csrc/<name>.cu``, else ``csrc/<name>.cpp``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.is_file() else CSRC / f"{name}.cpp"


def _flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS if source(name).suffix == ".cu" else CXX_FLAGS


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> Tuple[Path, ...]:
    """``source(name)`` and the headers of ``csrc/`` it includes, directly
    or through another header, each once."""
    found, todo = [], [source(name)]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes()) if (CSRC / inc.decode()).is_file()]
    return tuple(found)


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Tuple[float, Dict[str, str]]:
    """Compile every named library that is not built yet, all compiler runs
    at once.

    Returns (seconds, {name: compiler output}); raises ``CompilerMissing``
    without a host compiler for a ``.cpp``, and with the compiler's output if
    a build fails.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = source(name)
        compiler = _nvcc() if src.suffix == ".cu" else _cxx()
        cmd = [compiler, *_flags(name), "-o", str(tmp), str(src)]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError as e:
            raise CompilerMissing(f"{compiler}: {e}") from e
        procs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("compiling failed for " + ", ".join(failed) + ":\n" + "\n".join(logs[n] for n in failed))
    return time.perf_counter() - t0, logs


def load(name: str, functions: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library ``name``, built if needed, with its C signatures set.

    ``functions`` maps each C function to its argument types; every function
    returns an int, 0 on success (a kernel library's is a ``cudaError_t``).
    """
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in functions.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        if source(name).suffix == ".cu":
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, what: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}: {lib.cuda_error_string(code).decode()}")
