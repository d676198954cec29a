"""A later change adds a configuration, a traffic kind (its mix and its
driver), a cell and a per-layer metric as new files and new entries of
BENCHMARK.json, and edits no file the benchmark has: the harness finds
them all by name."""

import json

import pytest

from bench_support import BENCH, checkout, tiny_manifest

import run  # noqa: E402  (bench_support puts the benchmark on sys.path)

DRIVER = '''
def run(ctx):
    """A driver that needs no program: it reads its mix and its
    configuration and reports what they say."""
    value = ctx.mix["value"] * ctx.config["scale"]
    return {"attempted": 1, "failed": 0,
            "end_to_end": {"setup_s": 0.5, "echo_rate": value},
            "device": {"kind": "cpu", "memory_peak_bytes": None},
            "trace": None, "layer_data": {"echo": value},
            "checks": {}, "readings": {"echo_error": 0.0},
            "control": {"echo_error": 1.0} if ctx.control else None}
'''

READER = '''
def read(data):
    return 2.0 * data["echo"]
'''


def test_new_files_alone(tmp_path):
    before = {p.relative_to(BENCH): p.read_bytes()
              for p in BENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    bench = tiny_manifest()
    bench["configs"].append({"name": "echo-config", "source": "tests",
                             "file": "benchmark/configs/echo-config.json",
                             "reduced": [], "why": "a new configuration"})
    bench["workloads"].append({"name": "echo-cell", "config": "echo-config",
                               "traffic": "echo-mix", "chips": 1,
                               "why": "a new cell"})
    bench["end_to_end"].append({"name": "echo_rate", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["echo-cell"]})
    bench["per_layer"].append({"name": "echo_double", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "echo_rate",
                               "workloads": ["echo-cell"]})
    root = checkout(tmp_path, bench)
    here = root / BENCH.name
    (here / "configs" / "echo-config.json").write_text(
        json.dumps({"scale": 3.0, "reduced": []}))
    (here / "traffic" / "echo-mix.json").write_text(
        json.dumps({"driver": "echo_kind", "value": 7.0}))
    (here / "drivers" / "echo_kind.py").write_text(DRIVER)
    (here / "metrics" / "echo_double.py").write_text(READER)
    (here / "limits" / "echo-cell.json").write_text(
        json.dumps({"echo_error": 0.0}))

    plain = run.run_cell("echo-cell", 1, 1.0, False, "cpu", root=root)
    assert plain["correct"] is True
    assert plain["metrics"] == {
        "echo_rate": {"value": 21.0, "unit": "1/s"},
        "setup_s": {"value": 0.5, "unit": "s"}}
    traced = run.run_cell("echo-cell", 1, 1.0, True, "cpu", root=root)
    assert traced["metrics"] == {"echo_double": {"value": 42.0,
                                                 "unit": "1/s"}}
    control = run.run_cell("echo-cell", 1, 1.0, False, "cpu", root=root,
                           control=True)
    assert control["correct"] is True
    assert control["control_correct"] is False
    assert control["control_compared"] == {
        "echo_error": {"value": 1.0, "limit": 0.0}}
    after = {p.relative_to(BENCH): p.read_bytes()
             for p in BENCH.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert after == before
    copied = {p.relative_to(here) for p in here.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    for rel, data in before.items():
        if rel in copied:
            assert (here / rel).read_bytes() == data


# per-layer metrics that a later change adds for the existing drivers: a
# host span's time from the trace, and the server's own handle times
SPAN_READER = '''
def read(data):
    span = ((data.get("trace") or {}).get("spans") or {}).get("train step")
    if not span or not span["count"]:
        return None
    return 1e3 * span["seconds"] / span["count"]
'''

HANDLE_READER = '''
import numpy as np


def read(data):
    seconds = [h["handle_s"] for h in data.get("handled", ())
               if h["in_window"] and h["path"] == "/timerange-change"]
    return float(np.median(seconds)) * 1e3 if seconds else None
'''


@pytest.mark.parametrize("cell, name, source, reader", [
    ("tiny-train", "traced_step_ms", "program_span", SPAN_READER),
    ("tiny-serve-edit", "edit_handle_ms", "host_clock", HANDLE_READER),
])
def test_new_metric_of_an_existing_driver(tmp_path, cell, name, source,
                                          reader):
    bench = tiny_manifest()
    moves = {"tiny-train": "train_notes_per_s",
             "tiny-serve-edit": "edit_p50_ms"}[cell]
    bench["per_layer"].append({"name": name, "unit": "ms",
                               "better": "lower", "source": source,
                               "layer": "training step", "moves": moves,
                               "workloads": [cell]})
    root = checkout(tmp_path, bench)
    (root / BENCH.name / "metrics" / f"{name}.py").write_text(reader)
    traced = run.run_cell(cell, 2 ** 31 + 7, 0.5, True, "cpu", root=root)
    assert traced["correct"] is True, traced["compared"]
    assert traced["metrics"][name]["value"] > 0
