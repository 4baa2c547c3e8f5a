"""The harness refuses to run without a card and never falls back to the
CPU: no result line, an exit code other than 0."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(args, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=env)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["--workload", "r50_bf16.eval", "--seed", "4294967311", "--seconds", "1", "--trace", "0"], env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_refuses_an_unknown_cell():
    out = _run(["--workload", "no_such_cell", "--seed", "1", "--seconds", "1"])
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_needs_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and perfbench/, the run fails
    without a result."""
    import shutil

    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "r50_bf16.eval", "--seed", "3",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_the_card_is_seen(card):
    from perfbench.harness import core

    core.require_cards(1)
