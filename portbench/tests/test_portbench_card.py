"""One short run of every cell on the card (skipped without one)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = json.load(open(ROOT + "/BENCHMARK.json"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2 ** 31 + 99),
                          "--seconds", "3", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
