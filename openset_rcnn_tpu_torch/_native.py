"""Build and load every native library of the port: the CUDA kernels, the
host resize and the evaluation core.

Each library has one description (``LIBRARIES``): its source, its
compiler's flags and its C functions' signatures. A ``.cu`` source of
``csrc/`` has a plain C interface and is compiled with ``nvcc`` for
``sm_90a`` (Hopper); nothing includes PyTorch's headers, so a build takes
seconds. A ``.cpp`` source (``csrc/resize_bilinear.cpp``, and
``native/evalcore.cpp`` where it lies, with ``native/Makefile``'s flags) is
built by the host compiler (``$CXX``, else ``g++``, else ``c++``) for the
machine it runs on. Each builds on first use into its own shared library
under ``_build/`` and is loaded with ``ctypes``. The library's file name
carries a hash of its source, of every header it includes from its own
directory (``#include "<header>"``, and theirs in turn) and of the flags,
so an edited source or header is rebuilt and never served stale.

``load`` is safe under threads: the first caller builds, others wait, and
once a library is loaded a call takes no lock. Its outcome is kept for the
process: without a compiler it raises ``CompilerMissing``, and a compiler
that failed raises ``BuildFailed`` with its output, each time without
compiling again.

There is no fast math in the port's own sources: ``--fmad=false`` keeps
every multiply and add rounded on its own, as the plain PyTorch versions
compute them, so the NMS keep masks and the IoU matcher's outputs match
exactly; ``-ffp-contract=off`` does the same for host code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, NamedTuple, Sequence, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("roi_align_fwd", "roi_align_bwd", "iou_match", "nms_keep", "frozen_bn_act", "mvit_pool_norm",
           "launch_floor")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")
MAKEFILE_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")  # native/Makefile's


class Library(NamedTuple):
    source: str  # a file of ``csrc/``, or an absolute path
    flags: Tuple[str, ...]
    functions: Dict[str, Tuple[Any, Sequence[Any]]]  # C function -> (return type, argument types)


_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_i32, _i64, _f64, _u8 = (ctypes.POINTER(t) for t in (ctypes.c_int32, ctypes.c_int64, ctypes.c_double, ctypes.c_uint8))
_ROI_FWD = [_p] * 4 + [_i] * 8 + [_f] * 4 + [_p, _p] + [_i] * 5
_ROI_BWD = [_p] * 4 + [_i] * 8 + [_f] * 4 + [_p] * 3 + [_i] * 5 + [_p]

# every kernel returns a cudaError_t, 0 on success, and the host resize 0 on success
LIBRARIES = {
    "roi_align_fwd": Library("roi_align_fwd.cu", NVCC_FLAGS, {
        "roi_align_fwd": (_i, _ROI_FWD + [_p, _p]),
        "roi_align_window_fwd": (_i, _ROI_FWD + [_i, _p, _p]),
    }),
    "roi_align_bwd": Library("roi_align_bwd.cu", NVCC_FLAGS, {
        "roi_align_bwd": (_i, _ROI_BWD), "roi_align_bwd_bf16": (_i, _ROI_BWD),
    }),
    "iou_match": Library("iou_match.cu", NVCC_FLAGS, {"iou_match": (_i, [_p] * 3 + [_i] * 3 + [_p] * 6)}),
    "nms_keep": Library("nms_keep.cu", NVCC_FLAGS, {
        "nms_keep": (_i, [_p, _p, _i, _i, _f, _p, _p, _p]), "nms_max_boxes": (_i, []),
    }),
    # x, r, y, scale, bias, mean, var, eps, the residual's four buffers and eps, N, C, H * W, bf16,
    # channels_last, residual form, relu, vectorized, stream
    "frozen_bn_act": Library("frozen_bn_act.cu", NVCC_FLAGS, {
        "frozen_bn_act": (_i, [_p] * 7 + [_f] + [_p] * 4 + [_f] + [ctypes.c_int64] * 3 + [_i] * 5 + [_p]),
    }),
    # qkv, q, k, v, the three pooling weights, the three norms' scale and bias, eps, B, H, W, heads, d,
    # stride_q, stride_kv, q_window, kv_window, stream
    "mvit_pool_norm": Library("mvit_pool_norm.cu", NVCC_FLAGS, {
        "mvit_pool_norm": (_i, [_p] * 13 + [_f] + [_i] * 9 + [_p]),
    }),
    "launch_floor": Library("launch_floor.cu", NVCC_FLAGS, {"empty_launch": (_i, [_i, _i, _p])}),
    "resize_bilinear": Library("resize_bilinear.cpp", CXX_FLAGS, {
        "resize_bilinear_u8c3": (_i, [_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i,
                                      _p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, _i]),
    }),
    "evalcore": Library(str(_PKG.parent / "native" / "evalcore.cpp"), MAKEFILE_FLAGS, {
        "greedy_match": (None, [_f64, _i32, _i32, _f64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8, _u8]),
        "nms_sorted": (ctypes.c_int64, [_f64, ctypes.c_int64, ctypes.c_double, _u8]),
        # ious, d_area, g_area, g_crowd, area_lo, area_hi, A, iou_thrs, T, D, G, ioff, goff, doff, n_img, sum_d,
        # out matched, out ignore, out n_gt
        "match_category": (None, [_f64, _f64, _f64, _i32, _f64, _f64, ctypes.c_int64, _f64, ctypes.c_int64,
                                  _i64, _i64, _i64, _i64, _i64, ctypes.c_int64, ctypes.c_int64, _u8, _u8, _i32]),
    }),
}


class CompilerMissing(RuntimeError):
    """No compiler for a library's source here."""


class BuildFailed(RuntimeError):
    """A compiler failed; the message holds its output."""


_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_failed: Dict[str, Exception] = {}


def _compiler(src: Path) -> str:
    if src.suffix == ".cu":
        for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
            if cand and os.path.exists(cand):
                return cand
        raise CompilerMissing("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise CompilerMissing("no host compiler ($CXX, g++ or c++) to build the host libraries")
    return cxx


def source(name: str) -> Path:
    return CSRC / LIBRARIES[name].source


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> Tuple[Path, ...]:
    """``source(name)`` and the headers of its directory it includes,
    directly or through another header, each once."""
    found, todo = [], [source(name)]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())
                 if (path.parent / inc.decode()).is_file()]
    return tuple(found)


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(LIBRARIES[name].flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Tuple[float, Dict[str, str]]:
    """Compile every named library that is not built yet, all compiler runs
    at once, each into a temporary file of its own that is renamed when it
    is done, so no process or thread loads a half-written library.

    Returns (seconds, {name: compiler output}); raises ``CompilerMissing``
    without a compiler, and ``BuildFailed`` with the compiler's output if a
    build fails.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        src = source(name)
        compiler = _compiler(src)
        fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.Popen([compiler, *LIBRARIES[name].flags, "-o", tmp, str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError as e:
            os.unlink(tmp)
            raise CompilerMissing(f"{compiler}: {e}") from e
        procs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            os.unlink(tmp)
            continue
        os.replace(tmp, out)
    if failed:
        raise BuildFailed("compiling failed for " + ", ".join(failed) + ":\n" + "\n".join(logs[n] for n in failed))
    return time.perf_counter() - t0, logs


def _open(name: str) -> ctypes.CDLL:
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    functions = dict(LIBRARIES[name].functions)
    if source(name).suffix == ".cu":
        functions["cuda_error_string"] = (ctypes.c_char_p, [_i])
    for fn, (restype, argtypes) in functions.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(argtypes)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The library ``name``, built if needed, with its C signatures set.

    Raises ``CompilerMissing`` or ``BuildFailed`` (see the module
    docstring), or what loading it raised, on this and every later call.
    """
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            if name not in _loaded and name not in _failed:
                try:
                    _loaded[name] = _open(name)
                except Exception as e:
                    _failed[name] = e
            if name in _failed:
                raise _failed[name].with_traceback(None)
            lib = _loaded[name]
    return lib


def check(lib: ctypes.CDLL, what: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}: {lib.cuda_error_string(code).decode()}")
