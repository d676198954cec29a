"""The tiny checkout of ``bench_support`` with the tiny VQ-VAE training
cell beside the tiny serving and prior-training cells: its configuration
and mix (``data/tiny-vqvae*.json``) and its limits, and each metric that
lists the VQ-VAE cell listing the tiny one instead. Loaded before the
test modules, so every test that builds the tiny manifest or checkout
gets all three cells."""

from __future__ import annotations

import shutil

import bench_support
from bench_support import BENCH, DATA

CELLS = {"serve-edit": "tiny-serve-edit",
         "train-bottom-prior": "tiny-train",
         "vqvae-train-jukebox": "tiny-vqvae-train"}

# the tiny VQ-VAE on the CPU (the program's plain versions) against the
# reference; a planted fault reads far above each
bench_support.TINY_LIMITS["tiny-vqvae-train"] = {
    "stats_gap": 1e-4, "loss_gap": 1e-4, "trio_gap": 1e-4,
    "grad_gap": 1e-3, "update_gap": 1e-2, "codebook_gap": 1e-3,
    "feed_rows": 0}

_checkout = bench_support.checkout


def tiny_manifest() -> dict:
    bench = bench_support.json.loads(
        (bench_support.ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": name, "source": "tests", "reduced": [],
         "file": f"benchmark/configs/{name}.json", "why": "CPU tests"}
        for name in ("tiny-serve", "tiny-train", "tiny-vqvae")]
    bench["workloads"] = [
        {"name": cell, "config": config, "traffic": f"{config}-mix",
         "chips": 1, "why": "CPU tests"}
        for cell, config in (("tiny-serve-edit", "tiny-serve"),
                             ("tiny-train", "tiny-train"),
                             ("tiny-vqvae-train", "tiny-vqvae"))]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [CELLS[w] for w in metric["workloads"]]
    return bench


def checkout(tmp, manifest: dict = None):
    root = _checkout(tmp, manifest or tiny_manifest())
    for suffix in ("", "-mix"):
        shutil.copy(DATA / f"tiny-vqvae{suffix}.json",
                    root / BENCH.name / ("traffic" if suffix else "configs")
                    / f"tiny-vqvae{suffix}.json")
    return root


bench_support.tiny_manifest = tiny_manifest
bench_support.checkout = checkout
