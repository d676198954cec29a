"""BENCHMARK.json against the benchmark's contract: keys, names, units, and
every file a cell, a mix, a metric or a limit is found by."""

import json
import re

import pytest

from bench_support import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["why"])
        assert LINE.match(c["source"])
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16


@pytest.mark.parametrize("key", ["workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(bench, key):
    names = [m["name"] for m in bench[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (BENCH / "drivers" / f"{mix['driver']}.py").is_file()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits, "a cell's correctness has limits"
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in bench["per_layer"]:
        # a per-layer metric always lists its cells (run.py reads no other
        # way of choosing them)
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert m["source"] in SOURCES and LINE.match(m["layer"])
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
        layers.setdefault(m["layer"], m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in bench["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"])


def test_layers_are_perf_md_layers(bench):
    perf = (ROOT / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert f"| {m['layer']} |" in perf
