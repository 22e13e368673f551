"""Without a card, and without the program, a run fails and prints no
result: the measurement never falls back to the CPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "diamond-f32-kfac-4096",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_run_without_a_card_exits_nonzero_with_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_with_only_the_benchmark_exits_nonzero_with_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_program_asked_for_the_card_does_not_fall_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from portbench import harness
    from portbench.tests.tiny import make_cell

    with pytest.raises(Exception):
        harness.run_cell(make_cell(tmp_path), 1, 0.0, False, device="cuda")
