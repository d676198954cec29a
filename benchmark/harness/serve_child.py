"""The serving cell's server process: the program's NOTONO server
(``serve/server.py``'s ``ServerState`` and ``app``) on an ephemeral port
of 127.0.0.1, built from a configuration file with parameters drawn from
the seed.

Run by ``drivers/edit_loop.py`` as ``python benchmark/harness/serve_child.py
'<json>'`` with ``{"config": path, "seed": n, "trace": 0|1, "device":
"cuda"|"cpu", "plant": optional fault}``. It prints ``{"port": n}`` on its
standard output once it serves, then reads commands from its standard
input: ``window_start``, ``window_stop``, ``trace_start`` and
``trace_stop`` (each answered with ``ok`` once done) and ``stop``, after
which it prints its record (``BENCH_STATS {...}``) and exits.

What it adds to the server, all outside the handlers' own work:

- a wrapper of ``App.handle`` that reads the host clock around each call
  and the kernels' launch counters (``fused_decode_scan.launches``,
  ``fused_prefix_prime.launches``) before and after it, and names the
  call with a ``record_function`` span when traced;
- ``ServerState.gumbel_source``: the Gumbel noise of each edit, drawn from
  the seed and the edit's number (``bench_edit`` in the query), sliced to
  the rows of the scan the server runs (``bench_cols``: the mask's
  columns);
- when traced: CUDA events around each call of ``fused_decode_scan`` and
  ``fused_prefix_prime`` in the window (with the operations and bytes each
  call needs, from ``harness/frozen.py``), and ``torch.profiler`` from
  ``trace_start`` to ``trace_stop``, which come after the window.

``plant`` (the fault tests and ``calibrate.py --fault`` only) names a
fault of ``harness/faults.py`` (``harness.faults:<name>``) that breaks the
program on purpose once the state is built.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import sys
import time

T0 = time.perf_counter()
HERE = pathlib.Path(__file__).resolve()
# the benchmark's modules, and the program beside the benchmark
sys.path[:0] = [str(HERE.parents[1]), str(HERE.parents[2])]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import faults, frozen, program, trace  # noqa: E402
from harness.edits import column_masks  # noqa: E402
from harness.seeds import derive  # noqa: E402
from harness.weights import gumbel  # noqa: E402


def noise_rows(cfg_prior: dict) -> int:
    """Rows of an edit's full noise: one per position of the prior's scan
    with its start symbols, ``L + C - 1``."""
    shape = cfg_prior["shape"]
    cond = cfg_prior.get("condition_shape") or shape
    channels = (shape[0] // cond[0]) * (shape[1] // cond[1])
    return shape[0] * shape[1] + channels - 1


def edit_noise(cfg: dict, seed: int, which: str, edit: int, device):
    """[L + C - 1, n_class] Gumbel noise of one prior in one edit: row p is
    the noise of the scan's with-start position p."""
    prior = cfg[f"{which}_prior"]
    return gumbel((noise_rows(prior), prior["n_class"]),
                  derive(seed, "gumbel", which, edit), device)


class Timer:
    """CUDA events on the card, the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        if self.cuda:
            return a.elapsed_time(b) / 1e3
        return b - a


def wrap_entry(name: str, orig, bound, calls, window, timer):
    """Replace every reference to ``orig`` in the program's modules, but in
    its own module (whose launch counter names it), by a wrapper that
    times each call inside the window."""
    def wrapper(*args, **kwargs):
        if not window["open"]:
            return orig(*args, **kwargs)
        with torch.profiler.record_function(trace.KERNEL_SPAN + name):
            a = timer.start()
            out = orig(*args, **kwargs)
            b = timer.start()
        nbytes, ops = bound(args, kwargs)
        calls.append((a, b, nbytes, ops))
        return out

    for mod in list(sys.modules.values()):
        if (mod is None or not getattr(mod, "__name__", "").startswith(
                program.PACKAGE) or mod.__name__ == orig.__module__):
            continue
        for attr, value in list(vars(mod).items()):
            if value is orig:
                setattr(mod, attr, wrapper)


def log(message: str) -> None:
    print(f"serve_child {time.perf_counter() - T0:.3f}s {message}",
          file=sys.stderr, flush=True)


def build_state(cfg: dict, seed: int, device):
    from interactive_spectrogram_inpainting_tpu_torch.serve import server
    from interactive_spectrogram_inpainting_tpu_torch.signal.spectrogram \
        import get_spectrograms_helper
    log("program imported")
    vqvae = program.build_vqvae(cfg, seed, device)
    log("VQ-VAE built")
    top = program.build_prior(cfg, "top_prior", seed, device)
    bottom = program.build_prior(cfg, "bottom_prior", seed, device)
    log("priors built")
    state = server.ServerState(
        vqvae, top, bottom, get_spectrograms_helper(**cfg["spectrogram"]),
        program.label_encoders(cfg), fs_hz=cfg["spectrogram"]["fs_hz"],
        max_sound_duration_s=cfg["max_sound_duration_s"], device=device,
        seed=derive(seed, "server") & 0xFFFFFFFF)
    server.STATE = state
    return server, state


def main() -> None:
    log("imported")
    args = json.loads(sys.argv[1])
    out = os.fdopen(os.dup(1), "w", buffering=1)
    sys.stdout = sys.stderr  # the program's prints stay off the protocol
    cfg = json.loads(pathlib.Path(args["config"]).read_text())
    seed, traced = int(args["seed"]), bool(args["trace"])
    device = torch.device(args["device"])
    torch.zeros(1, device=device)
    log("device ready")
    server, state = build_state(cfg, seed, device)
    log("state built")
    if args.get("plant"):
        faults.resolve(args["plant"])(state)

    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_scan_kernel, prefix_prime_kernel)
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        scan_range)
    scan_fn = decode_scan_kernel.fused_decode_scan
    prime_fn = prefix_prime_kernel.fused_prefix_prime
    timer = Timer(device)
    window = {"open": False, "traced": False}
    current: dict = {}
    handled = []
    scan_calls, prime_calls = [], []
    if traced:
        wrap_entry("fused_decode_scan", scan_fn, frozen.scan_bound,
                   scan_calls, window, timer)
        wrap_entry("fused_prefix_prime", prime_fn, frozen.prime_bound,
                   prime_calls, window, timer)

    def gumbel_source(which: str):
        cols = current["cols"]
        model = state.top if which == "top" else state.bottom
        mask = column_masks(cfg, cols)[which == "bottom"]
        p0, steps = scan_range(model, *state.mask_scan_bounds(which, mask))
        return edit_noise(cfg, seed, which, current["edit"], device)[
            p0:steps]

    state.gumbel_source = gumbel_source
    orig_handle = server.app.handle

    def handle(request):
        edit = request.args.get("bench_edit")
        cols = request.args.get("bench_cols")
        current["edit"] = None if edit is None else int(edit)
        current["cols"] = (None if cols is None
                           else tuple(int(c) for c in cols.split(",")))
        span = (torch.profiler.record_function(f"handle {request.path}")
                if traced else contextlib.nullcontext())
        scans, primes = scan_fn.launches, prime_fn.launches
        with span:
            t0 = time.perf_counter()
            response = orig_handle(request)
            t1 = time.perf_counter()
        handled.append({"path": request.path, "edit": current["edit"],
                        "handle_s": t1 - t0, "status": response.status,
                        "scans": scan_fn.launches - scans,
                        "primes": prime_fn.launches - primes,
                        "in_window": window["open"],
                        "traced": window["traced"]})
        return response

    server.app.handle = handle
    httpd = server.app.run(host="127.0.0.1", port=0, background=True)
    log(f"serving on port {httpd.server_address[1]}")
    out.write(json.dumps({"port": httpd.server_address[1]}) + "\n")

    tracing = summary = None
    for line in sys.stdin:
        command = line.strip()
        if command == "window_start":
            window["open"] = True
        elif command == "window_stop":
            window["open"] = False
        elif command == "trace_start":
            tracing = trace.start(device)
            window["traced"] = True
        elif command == "trace_stop":
            window["traced"] = False
            if device.type == "cuda":
                torch.cuda.synchronize()
            summary = trace.stop(tracing)
        elif command == "stop":
            break
        out.write("ok\n")
    httpd.shutdown()
    httpd.server_close()
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    record = {
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "memory_peak_bytes": peak,
        "handled": handled,
        "scan_calls": [(timer.seconds(a, b), n, o)
                       for a, b, n, o in scan_calls],
        "prime_calls": [(timer.seconds(a, b), n, o)
                        for a, b, n, o in prime_calls],
        "trace": summary,
        "modules": sorted({name.split(".")[0] for name in sys.modules}),
    }
    out.write("BENCH_STATS " + json.dumps(record) + "\n")
    out.flush()


if __name__ == "__main__":
    main()
