"""The command refuses to run where it cannot measure, and prints no
result: no card, or a directory holding only the benchmark's files."""
import shutil
import subprocess
import sys

import pytest

from pmbench.tests.conftest import ROOT

ARGS = ["-m", "pmbench.run", "--workload", "L1-panel", "--seed",
        str(2**31 + 5), "--seconds", "1", "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return                          # a card: the card test covers it
    out = run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "pmbench", tmp_path / "pmbench")
    out = run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_run_on_the_card(cuda):
    """One short run of the smallest cell (``-m gpu`` on a card)."""
    import json

    out = subprocess.run([sys.executable, *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
