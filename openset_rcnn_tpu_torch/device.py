"""Device choice and numerics for the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names one.

    With no GPU and no explicit request this raises: the port never falls
    back to the CPU on its own.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


@contextlib.contextmanager
def entry_numerics(deterministic: bool = False) -> Iterator[None]:
    """The numerics of an entry point, whatever the caller's process-wide
    flags, which are restored on exit.

    f32 convolutions and matmuls compute in f32 (no TF32) and bf16 matmuls
    sum in f32 (no reduced-precision reductions), as the JAX package and the
    port's CPU path compute them; PyTorch's defaults let cuDNN use TF32 and
    bf16 GEMMs reduce in bf16. ``deterministic`` (the train step) also picks
    cuDNN's deterministic algorithms without autotuning, so two steps from
    one state give bitwise equal parameters.
    """
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        if deterministic:
            flags = dict(enabled=True, benchmark=False, deterministic=True)
        else:
            flags = dict(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic)
        with cudnn.flags(allow_tf32=False, **flags):
            yield
    finally:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = saved


def numerics_flags() -> Dict[str, bool]:
    """The process-wide flags that ``entry_numerics`` sets, as they stand."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    return {
        "cudnn.allow_tf32": cudnn.allow_tf32,
        "matmul.allow_tf32": matmul.allow_tf32,
        "matmul.allow_bf16_reduced_precision_reduction": matmul.allow_bf16_reduced_precision_reduction,
        "cudnn.deterministic": cudnn.deterministic,
        "cudnn.benchmark": cudnn.benchmark,
    }
