"""On the card: each cell runs and is correct, and the control (the plain
reference in the precision below the configuration's: float8 for the
serving cell's bfloat16 sampling, TF32 for the training cell's float32)
fails the comparison at the cell's own size on three seeds.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -q

Skipped without a card (decided in the ``card`` fixture)."""

import json
import subprocess
import sys

import pytest

from bench_support import BENCH, ROOT

import run  # noqa: E402  (bench_support puts the benchmark on sys.path)

CELLS = ("serve-edit", "train-bottom-prior")
SEEDS = (2 ** 31 + 501, 2 ** 31 + 502, 2 ** 31 + 503)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", str(SEEDS[0]), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(card, cell):
    for seed in SEEDS:
        result = run.run_cell(cell, seed, 3.0, False, "cuda", control=True)
        assert result["correct"] is True, (seed, result["compared"])
        assert result["control_correct"] is False, (
            seed, result["control_compared"])
