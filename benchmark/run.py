"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Everything that belongs to a cell is found by
name: the cell in ``BENCHMARK.json`` (its configuration and its traffic
mix), ``benchmark/configs/<file>`` (the configuration as it is run),
``benchmark/traffic/<mix>.json`` (the mix's parameters and the driver that
reads them), ``benchmark/drivers/<driver>.py``, ``benchmark/limits/<cell>.json``
(the limits of the comparison that decides ``correct``) and, with
``--trace 1``, ``benchmark/metrics/<metric>.py`` for each per-layer metric.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device`` and,
traced, ``breakdown``; then ``compared``, each number the comparison read
beside its limit, which standard error also ends with. Without a CUDA card
(or with fewer than the cell asks for), without the program beside the
benchmark, or when JAX or the JAX package is loaded, it prints no result
and exits with another code than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "interactive_spectrogram_inpainting_tpu")
PROGRAM = "interactive_spectrogram_inpainting_tpu_torch"


class Refused(Exception):
    """A run that must print no result."""


@dataclasses.dataclass
class Context:
    cell: str
    config_path: pathlib.Path
    config: Dict
    mix: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    plant: Any = None
    control: bool = False
    # checks the card and makes ``device`` a torch.device; a driver calls
    # it once whatever it starts before torch is imported has started
    ready: Any = None


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest(root: pathlib.Path = ROOT) -> Dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise Refused(f"{path} not found: run from the root of a checkout")
    return json.loads(path.read_text())


def cell_entries(bench: Dict, cell: str):
    """(workload entry, configuration entry) of a cell."""
    work = [w for w in bench["workloads"] if w["name"] == cell]
    if not work:
        raise Refused(f"no cell named {cell!r} in BENCHMARK.json")
    config = [c for c in bench["configs"] if c["name"] == work[0]["config"]]
    return work[0], config[0]


def metrics_of(bench: Dict, cell: str):
    """(end-to-end, per-layer) metric entries the cell reports: an
    end-to-end metric without ``workloads`` is every cell's; a per-layer
    metric always lists its cells."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    layer = [m for m in bench["per_layer"] if cell in m["workloads"]]
    return e2e, layer


def forbidden_modules(names) -> list:
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout
        return float(text.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def require_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: the benchmark "
                      "runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, "
                      f"{torch.cuda.device_count()} found")


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             root: pathlib.Path = ROOT, plant=None, control: bool = False,
             t_start: float = T_START, chips: int = 0) -> Dict:
    """Run a cell; -> the result object (without the device's platform and
    count, which ``main`` adds on the card). ``chips``: the cards to look
    for (none on the CPU)."""
    from harness import checks
    here = root / BENCH.name
    bench = manifest(root)
    work, config = cell_entries(bench, cell)
    config_path = root / config["file"]
    mix = json.loads((here / "traffic" / f"{work['traffic']}.json")
                     .read_text())
    driver = load_module(here / "drivers" / f"{mix['driver']}.py",
                         f"bench_driver_{mix['driver']}")
    ctx = Context(cell=cell, config_path=config_path,
                  config=json.loads(config_path.read_text()), mix=mix,
                  seed=seed, seconds=seconds, trace=trace, device=device,
                  t_start=t_start, plant=plant, control=control)

    def ready():
        import torch
        if chips:
            require_cards(torch, chips)
        ctx.device = torch.device(device)
    ctx.ready = ready
    out = driver.run(ctx)
    e2e, layer = metrics_of(bench, cell)
    metrics = {}
    if not trace:
        for m in e2e:
            value = out["end_to_end"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in layer:
            reader = load_module(here / "metrics" / f"{m['name']}.py",
                                 f"bench_metric_{m['name']}")
            value = reader.read(out["layer_data"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = json.loads((here / "limits" / f"{cell}.json").read_text())
    correct, compared = checks.compare(out["readings"], limits)
    result = {"correct": bool(correct and out["failed"] == 0),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dict(out["device"])}
    if trace and out["trace"] is not None:
        result["device"]["busy_s"] = out["trace"]["busy_s"]
        result["device"]["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                               "idle_gaps": out["trace"]["idle_gaps"]}
    result["checks"] = out["checks"]
    if out.get("failures"):
        result["checks"]["failures"] = out["failures"]
    if control:
        # the control goes through the same comparison, over the numbers
        # it reads; it has to come out not correct
        result["control_correct"], result["control_compared"] = \
            checks.compare_control(out["control"], limits)
    result["compared"] = compared
    loaded = forbidden_modules(list(sys.modules)
                               + out.get("child_modules", []))
    if loaded:
        raise Refused(f"modules of JAX or of the JAX package were loaded: "
                      f"{loaded}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton_cache"))
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    try:
        if importlib.util.find_spec(PROGRAM) is None:
            raise Refused(f"the program ({PROGRAM}) is not beside the "
                          f"benchmark in {ROOT}")
        work, _ = cell_entries(manifest(), args.workload)
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", chips=int(work["chips"]))
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    compared = result.pop("compared")
    result["device"] = {"platform": "gpu", "count": int(work["chips"]),
                        **result["device"],
                        "power_limit_w": power_limit_w()}
    result["compared"] = compared
    for name, item in compared.items():
        print(f"compared {name} {item['value']!r} limit {item['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
