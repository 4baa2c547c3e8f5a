"""The control comes out not correct: the reference in the nearest
precision below the configuration's (its file's ``precision.control``),
put in the program's place, at a size a test run holds, through the same
``core.drive`` and limits as a benchmark run. The readings that set the
limits were taken on the card at the cells' own sizes
(``perfbench/calibrate.py``, PERF.md).

fp8 (the control under the bf16 configuration) is emulated exactly on the
CPU; TF32 (under the f32 configuration) exists only on the card, so that
test is marked ``cuda``.
"""
import time

import pytest
import torch

from perfbench.harness import core, specs
from perfbench.tests.small import small_cell


def _control(name, device, workdir, seed=23):
    """A small run of cell ``name`` with the control in the program's place
    in the comparison; the run with its checks."""
    cell = small_cell(name)
    r = core.Run(cell=cell, seed=seed, seconds=0.0, trace=False, device=device, t_start=time.perf_counter())
    r.workdir = str(workdir)
    core.drive(r, specs.entry(cell["entry"]), r.config["precision"]["control"])
    return r


def _fails(r):
    assert r.checks and not all(c.ok for c in r.checks), [(c.name, c.value, c.limit) for c in r.checks]


def test_fp8_control_fails_training(tmp_path):
    _fails(_control("r50_bf16.train", torch.device("cpu"), tmp_path))


@pytest.mark.parametrize("name", ["r50_bf16.eval", "r50_bf16.frame1"])
def test_fp8_control_fails_detection(name, tmp_path):
    _fails(_control(name, torch.device("cpu"), tmp_path))


@pytest.mark.cuda
def test_tf32_control_fails_vitdet(card, tmp_path):
    _fails(_control("vitdet_b.eval", card, tmp_path))
