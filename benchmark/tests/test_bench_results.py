"""The result line: its keys with ``--trace 0`` and ``--trace 1``, the
comparison last; and no result at all without a card or without the
program."""

import json
import shutil
import subprocess
import sys

import pytest

from bench_support import BENCH, ROOT, checkout

import run  # noqa: E402  (bench_support puts the benchmark on sys.path)

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("results"))


@pytest.mark.parametrize("trace", [False, True])
def test_training_cell_keys(root, trace):
    result = run.run_cell("tiny-train", 2 ** 31 + 3, 1.0, trace, "cpu",
                          root=root)
    assert list(result)[:5] == KEYS and list(result)[-1] == "compared"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    names = set(result["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert names == {"train_mfu_pct"}  # no device on the CPU
    else:
        assert names == {"setup_s", "train_notes_per_s"}
    for item in result["metrics"].values():
        assert set(item) == {"value", "unit"} and item["value"] > 0
    for item in result["compared"].values():
        assert set(item) == {"value", "limit"}
    json.dumps(result)


def test_serving_cell_keys(root):
    result = run.run_cell("tiny-serve-edit", 2 ** 31 + 4, 1.0, False, "cpu",
                          root=root)
    assert list(result)[:5] == KEYS and list(result)[-1] == "compared"
    assert result["correct"] is True, result["compared"]
    assert set(result["metrics"]) == {"setup_s", "edit_p50_ms",
                                      "edit_p95_ms"}
    assert result["checks"]["interactions"] == result["attempted"]


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "serve-edit",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "cuda" in proc.stderr.lower()


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, str(tmp_path / BENCH.name / "run.py"),
         "--workload", "serve-edit", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "not beside" in proc.stderr
