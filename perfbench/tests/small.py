"""A cell cut to a size the CPU runs in seconds, for the tests: small
buckets, batches, proposal counts and traffic, the widths of the model
unchanged. ``run_small`` drives the cell's entry loop on the CPU, past the
harness's look for a card."""
from __future__ import annotations

import copy
import time

import torch

from perfbench.harness import core, specs

CFG = {
    "INPUT": {"MIN_SIZE_TRAIN": [64, 80], "MAX_SIZE_TRAIN": 120, "MIN_SIZE_TEST": 80, "MAX_SIZE_TEST": 120},
    "TPU": {"TRAIN_BUCKET": [96, 128], "TEST_BUCKET": [96, 128], "EVAL_BATCH_SIZE": 2, "MAX_GT_PER_IMAGE": 8},
    "SOLVER": {"IMS_PER_BATCH": 2},
    "TEST": {"DETECTIONS_PER_IMAGE": 100},
    "DATALOADER": {"NUM_WORKERS": 1},
    "MODEL": {"RPN": {"PRE_NMS_TOPK_TRAIN": 200, "PRE_NMS_TOPK_TEST": 200},
              "ROI_HEADS": {"BATCH_SIZE_PER_IMAGE": 64}},
}
TRAFFIC = {"image_files": {"pool": 12, "sizes": [[60, 80, 0.5], [80, 60, 0.5]],
                           "gt_per_image": {"dist": "geometric", "mean": 2, "min": 1, "max": 4},
                           "box_side": {"dist": "log_uniform", "min": 8}},
           "frames": {"pool": 4, "sizes": [[72, 96, 1.0]]}}


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def small_cell(name: str) -> dict:
    cell = copy.deepcopy(specs.workload(name))
    _merge(cell["config_spec"]["cfg"], CFG)
    _merge(cell["traffic_spec"], TRAFFIC[cell["traffic_spec"]["kind"]])
    if "images_per_pass" in cell:
        cell["images_per_pass"] = 8
    if "sample" in cell:
        cell["sample"] = 8  # every image of a small pass
    return cell


def run_small(cell: dict, seed: int = 11, seconds: float = 0.0) -> core.Run:
    """The cell's entry loop on the CPU; the run with its checks."""
    r = core.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"),
                 t_start=time.perf_counter())
    r.line = core.execute(r, specs.entry(cell["entry"]))
    return r
