"""On the card: the VQ-VAE training cell runs and is correct, and its
control (the plain reference with cuDNN's and cuBLAS's TF32 on, the
precision below the configuration's float32) and each planted fault of
``harness/vqvae_faults.py`` fail the comparison at the cell's own size.

    python -m pytest benchmark/tests/test_bench_vqvae_card.py -m cuda -q

Skipped without a card (decided in the ``card`` fixture)."""

import json
import subprocess
import sys

import pytest

from bench_support import BENCH, ROOT

import run  # noqa: E402  (bench_support puts the benchmark on sys.path)
from harness import vqvae_faults  # noqa: E402

CELL = "vqvae-train-jukebox"
SEEDS = (2 ** 31 + 601, 2 ** 31 + 602, 2 ** 31 + 603)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs on the card only")


@pytest.mark.cuda
def test_cell_is_correct_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELL,
         "--seed", str(SEEDS[0]), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["compared"]


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(card):
    for seed in SEEDS:
        result = run.run_cell(CELL, seed, 3.0, False, "cuda", control=True)
        assert result["correct"] is True, (seed, result["compared"])
        assert result["control_correct"] is False, (
            seed, result["control_compared"])


@pytest.mark.cuda
@pytest.mark.parametrize("fault", vqvae_faults.TRAINING)
def test_fault_is_not_correct_on_the_card(card, fault):
    result = run.run_cell(CELL, SEEDS[1], 3.0, False, "cuda",
                          plant=f"harness.faults:{fault}")
    assert result["correct"] is False, result["compared"]
