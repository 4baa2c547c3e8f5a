"""Process groups: start them, query them, gather and reduce across them.

Port of ``openset_rcnn_tpu/parallel/multihost.py`` (``is_main_process :17``,
``num_processes :21``, ``initialize_distributed :28-62``, ``gather_object
:65-86``, ``reduce_dict :89-100``) and of d2's ``launch`` (reference
``train.py:287-294``, SURVEY.md §2.2). The JAX package runs one controller
per host over ``jax.distributed``; the port runs one process per GPU in a
``torch.distributed`` group, NCCL on CUDA and gloo on the CPU. Without a
group every query answers for a single process.
"""
from __future__ import annotations

import os
import pickle
import shutil
import socket
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def _group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def num_processes() -> int:
    dist = _group()
    return dist.get_world_size() if dist else 1


def process_index() -> int:
    dist = _group()
    return dist.get_rank() if dist else 0


def is_main_process() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Wait for every process of the group (no-op without one)."""
    dist = _group()
    if dist is not None and dist.get_world_size() > 1:
        dist.barrier()


def gather_object(obj: Any) -> List[Any]:
    """A picklable host object from every process, in rank order, on every
    process (the evaluators' ``comm.gather``)."""
    dist = _group()
    if dist is None or dist.get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def reduce_dict(metrics: Dict[str, float]) -> Dict[str, float]:
    """Mean of scalar metrics across processes, summed in f32 as the JAX
    package does (d2's ``comm.reduce_dict``, reference ``train.py:139``)."""
    if num_processes() == 1:
        return dict(metrics)
    keys = sorted(metrics)
    rows = gather_object(np.asarray([float(metrics[k]) for k in keys], np.float32))
    mean = np.stack(rows).mean(axis=0)
    return {k: float(v) for k, v in zip(keys, mean)}


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize_distributed(dist_url: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, local_rank: Optional[int] = None,
                           backend: Optional[str] = None, device_type: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``dist_url``: ``tcp://host:port`` or ``file:///path`` (a rendezvous
    file); the arguments left None are read from torchrun's ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` (``env://``), the
    twin of ``jax.distributed``'s autodetection. ``device_type``: "cuda"
    (the default when a GPU is visible) or "cpu". ``backend``: NCCL on CUDA
    and gloo on the CPU unless named; a CUDA group whose NCCL fails to come
    up raises, it never drops to gloo. On CUDA the rank's card,
    ``local_rank``, is made current before the group exists and before any
    other CUDA work (the rule of ``openset_rcnn_tpu/parallel/
    multihost.py:34-42``). Under gloo, ranks beyond the visible cards share
    them in turn, which is how one card holds several ranks; NCCL refuses two
    ranks on one card, so NCCL ranks may not outnumber the cards.

    A second call in a process that already has a group returns its device.
    """
    import torch.distributed as dist

    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    local_rank = local_rank if local_rank is not None else (_env_int("LOCAL_RANK") or 0)
    if dist_url is None and "MASTER_ADDR" in os.environ:
        dist_url = "env://"
    if dist_url is None or world_size is None or rank is None:
        raise ValueError("initialize_distributed needs dist_url, world_size and rank, or torchrun's RANK, "
                         "WORLD_SIZE and MASTER_ADDR")
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    if device_type == "cuda":
        backend = backend or "nccl"
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("initialize_distributed: device_type 'cuda' but no CUDA device is visible")
        if backend == "nccl" and local_rank >= cards:
            raise ValueError(f"local rank {local_rank} has no card of its own ({cards} visible); NCCL needs one card "
                             "per rank (gloo may share a card)")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        backend = backend or "gloo"
        if backend == "nccl":
            raise ValueError("NCCL needs CUDA tensors; the CPU runs gloo")
        device = torch.device("cpu")
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not {device_type!r}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=dist_url, world_size=world_size, rank=rank)
    return device


def free_port() -> int:
    """A TCP port of this host that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launched(local_rank: int, main_func: Callable, args: Sequence, world_size: int, machine_rank: int,
              per_machine: int, dist_url: str, backend: Optional[str], device_type: Optional[str],
              result_path: str) -> None:
    import torch.distributed as dist

    rank = machine_rank * per_machine + local_rank
    initialize_distributed(dist_url, world_size, rank, local_rank, backend, device_type)
    try:
        result = main_func(*args)
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def launch(main_func: Callable, num_processes_per_machine: int, num_machines: int = 1, machine_rank: int = 0,
           dist_url: Optional[str] = None, args: Sequence = (), backend: Optional[str] = None,
           device_type: Optional[str] = None) -> Any:
    """d2's ``launch``: run ``main_func(*args)`` in every process of a group
    of ``num_processes_per_machine x num_machines`` ranks; this machine's are
    ``machine_rank x num_processes_per_machine + local``. Returns what rank
    0's ``main_func`` returned (on machine 0; None on the others).

    One process per machine runs in this process; more are started with
    ``torch.multiprocessing``'s spawn (``main_func`` and ``args`` must
    pickle), and a rank that raises stops them all and raises here. A single
    process with no ``dist_url`` runs without a group. Several machines need
    ``dist_url``; one machine without it rendezvouses on a free local port.
    """
    world_size = num_processes_per_machine * num_machines
    if world_size == 1 and not dist_url:
        return main_func(*args)
    if not dist_url:
        if num_machines > 1:
            raise ValueError("--num-machines > 1 needs --dist-url (tcp://<machine 0's address>:<port>)")
        dist_url = f"tcp://127.0.0.1:{free_port()}"
    if num_processes_per_machine == 1:
        import torch.distributed as dist

        initialize_distributed(dist_url, world_size, machine_rank, 0, backend, device_type)
        try:
            return main_func(*args)
        finally:
            dist.destroy_process_group()

    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="launch_")
    result_path = os.path.join(work, "result.pkl")
    try:
        mp.start_processes(_launched, nprocs=num_processes_per_machine, join=True, start_method="spawn",
                           args=(main_func, tuple(args), world_size, machine_rank, num_processes_per_machine,
                                 dist_url, backend, device_type, result_path))
        if not os.path.exists(result_path):
            return None
        with open(result_path, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
