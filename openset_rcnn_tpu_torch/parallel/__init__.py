"""Multi-process training and evaluation: process groups and the
``(data, model)`` layout.

The port's counterpart of ``openset_rcnn_tpu/parallel``: ``multihost``
starts and queries the ``torch.distributed`` group (one process per GPU,
NCCL on CUDA, gloo on the CPU) and gathers host objects across it; ``mesh``
lays the ranks out as a ``(data, model)`` grid, with data-parallel training
through ``DistributedDataParallel`` and the box head's two FCs
tensor-parallel over the model axis. Without a group every query answers for
a single process.
"""
from .multihost import (
    barrier,
    gather_object,
    initialize_distributed,
    is_main_process,
    launch,
    num_processes,
    process_index,
    reduce_dict,
)

__all__ = ["barrier", "gather_object", "initialize_distributed", "is_main_process", "launch", "num_processes",
           "process_index", "reduce_dict"]
