"""``run.py`` refuses without a card, and in a tree without the program."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "seg2eye-train-bs16-bf16", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd: Path):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


def test_a_run_without_a_card_exits_non_zero_and_prints_nothing(no_card):
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_a_tree_of_the_benchmark_alone_exits_non_zero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
