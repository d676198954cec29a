"""Helpers of the benchmark's CPU tests: a checkout in a temporary directory
holding a copy of the benchmark, the program (linked), and a manifest of
tiny cells whose configurations, mixes and limits sit in files of their
own, as a later change would add them."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = pathlib.Path(__file__).resolve().parent / "data"
PROGRAM = "interactive_spectrogram_inpainting_tpu_torch"

for path in (str(BENCH), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

# the limits of the tiny cells: the tiny models on the CPU (the program's
# plain versions; bfloat16 sampling) against the reference; a planted fault
# reads far above each
TINY_LIMITS = {
    "tiny-serve-edit": {"token_gap": 0.05, "kept_changed": 0,
                        "audio_lsb": 2},
    "tiny-train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-2,
                   "feed_rows": 0},
}


def tiny_manifest() -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": "tiny-serve", "source": "tests", "reduced": [],
         "file": "benchmark/configs/tiny-serve.json", "why": "CPU tests"},
        {"name": "tiny-train", "source": "tests", "reduced": [],
         "file": "benchmark/configs/tiny-train.json", "why": "CPU tests"}]
    bench["workloads"] = [
        {"name": "tiny-serve-edit", "config": "tiny-serve",
         "traffic": "tiny-serve-mix", "chips": 1, "why": "CPU tests"},
        {"name": "tiny-train", "config": "tiny-train",
         "traffic": "tiny-train-mix", "chips": 1, "why": "CPU tests"}]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [
                {"serve-edit": "tiny-serve-edit",
                 "train-bottom-prior": "tiny-train"}[w]
                for w in metric["workloads"]]
    return bench


def checkout(tmp: pathlib.Path, manifest: dict = None) -> pathlib.Path:
    """A checkout under ``tmp``: the benchmark copied, the program linked,
    the tiny cells' files added."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / PROGRAM).symlink_to(ROOT / PROGRAM)
    for name in ("tiny-serve", "tiny-train"):
        shutil.copy(DATA / f"{name}.json",
                    root / BENCH.name / "configs" / f"{name}.json")
        shutil.copy(DATA / f"{name}-mix.json",
                    root / BENCH.name / "traffic" / f"{name}-mix.json")
    for cell, limits in TINY_LIMITS.items():
        (root / BENCH.name / "limits" / f"{cell}.json").write_text(
            json.dumps(limits))
    (root / "BENCHMARK.json").write_text(json.dumps(
        manifest or tiny_manifest()))
    return root
