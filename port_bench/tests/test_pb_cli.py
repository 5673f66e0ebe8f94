"""The command refuses to run, and prints no result, without the cards a
cell asks for, and in a directory that holds only the benchmark."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "unet34.train.b128", "--seed", str(2 ** 31 + 1), "--seconds", "1",
        "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "-m", "port_bench.run", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = run(ROOT)
    assert out.returncode == 3
    assert out.stdout == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
