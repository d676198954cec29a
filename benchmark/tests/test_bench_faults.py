"""The comparison that decides ``correct`` fails when it should: the control
(the reference in the precision below the configuration's) and a run with
the timed path broken underneath by each fault of ``harness/faults.py``
(every fault a cell can have), skipping only the harness's look for a card
(the tiny cells on the CPU)."""

import pytest

from bench_support import checkout

import run  # noqa: E402  (bench_support puts the benchmark on sys.path)
from harness import checks, faults  # noqa: E402

SEED = 2 ** 31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("faults"))


def failing(result):
    return [name for name, item in result["compared"].items()
            if not item["value"] <= item["limit"]]


@pytest.mark.parametrize("fault", faults.SERVING)
def test_serving_fault_is_not_correct(root, fault):
    result = run.run_cell("tiny-serve-edit", SEED, 1.0, False, "cpu",
                          root=root, plant=f"harness.faults:{fault}")
    assert result["correct"] is False
    assert failing(result)


@pytest.mark.parametrize("fault", faults.TRAINING)
def test_training_fault_is_not_correct(root, fault):
    result = run.run_cell("tiny-train", SEED, 0.5, False, "cpu", root=root,
                          plant=f"harness.faults:{fault}")
    assert result["correct"] is False
    assert failing(result)


def test_serving_control_is_not_correct(root):
    """The float8 reference in the program's place goes through the same
    comparison as the program and fails it, on the token gap."""
    result = run.run_cell("tiny-serve-edit", SEED, 1.0, False, "cpu",
                          root=root, control=True)
    assert result["correct"] is True
    assert result["control_correct"] is False
    table = result["control_compared"]
    assert set(table) == {"token_gap", "audio_lsb"}
    assert table["token_gap"]["value"] > 3 * table["token_gap"]["limit"]


@pytest.mark.parametrize("control, verdict", [
    ({"loss_gap": 1e-3, "grad_gap": 1e-4}, False),   # over one limit
    ({"loss_gap": 1e-6, "grad_gap": 1e-4}, True),    # within both
    ({}, False),                                     # no number: failed
    (None, False),
    ({"loss_gap": float("nan")}, False),
])
def test_control_goes_through_the_comparison(control, verdict):
    """``checks.compare_control``, through which ``run.run_cell`` passes
    the control's readings, holds them to the cell's limits of the numbers
    it reads; a control that reads no number has failed."""
    limits = {"loss_gap": 5.5e-6, "grad_gap": 5e-4, "feed_rows": 0}
    correct, table = checks.compare_control(control, limits)
    assert correct is verdict
    assert set(table) <= set(control or {})


def test_sound_runs_are_correct(root):
    for cell in ("tiny-serve-edit", "tiny-train"):
        result = run.run_cell(cell, SEED + 1, 0.5, False, "cpu", root=root)
        assert result["correct"] is True, (cell, result["compared"])
