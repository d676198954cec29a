"""Driver of the edit-and-listen loop: one musician, closed loop, no think
time. Each interaction posts ``/timerange-change`` (``layer=top``: the top
prior's inpaint cascading into the bottom prior) with the codes the
previous one returned, then ``/get-audio`` of the result.

The mix file gives the temperature and the warm-up's mask. The masked
range of each edit runs over the contiguous column ranges of the top
codemap, dealt in decks: each range once a deck, in an order shuffled from
the seed (for four columns: 40 % one column, 30 % two, 20 % three, 10 %
the whole frame). The first codes and each edit's pitch and family are
drawn from the seed, and so is the Gumbel noise the server samples with
(``harness/serve_child.py``).

Traced (``--trace 1``), the window runs as it does untraced, the scan and
prime calls timed by CUDA events; after it, from the next deck's first
edit on, the mix's ``traced_decks`` whole decks run under the profiler,
so that its cost stays out of the window and is the same in every run.

The server runs in a child process (``harness/serve_child.py``), started
before this process imports torch; the client runs here, so it shares no
interpreter lock with the handler thread. Once the window has closed and
the server has exited, every interaction is held against the plain
reference (``harness/edit_check.py``) on the same device, those after
the window too.
"""

from __future__ import annotations

import http.client
import json
import os
import pathlib
import struct
import subprocess
import sys
import time
from typing import Dict

import numpy as np

from harness import frozen
from harness.edits import Plan, column_masks, column_ranges

CHILD = pathlib.Path(__file__).resolve().parents[1] / "harness" / \
    "serve_child.py"
REQUEST_TIMEOUT_S = 120.0
# a checkout's first run builds the kernel libraries inside its first edit
WARMUP_TIMEOUT_S = 1100.0


def log(ctx, message: str) -> None:
    print(f"edit_loop {time.perf_counter() - ctx.t_start:.3f}s {message}",
          file=sys.stderr, flush=True)


def wav_samples(data: bytes) -> np.ndarray:
    """The int16 samples of a 16-bit PCM WAV."""
    i = data.index(b"data")
    size = struct.unpack("<I", data[i + 4:i + 8])[0]
    return np.frombuffer(data[i + 8:i + 8 + size], dtype="<i2")


class Client:
    def __init__(self, port: int, timeout: float = REQUEST_TIMEOUT_S):
        self.port = port
        self.timeout = timeout

    def post(self, path: str, query: str, body: dict) -> bytes:
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=self.timeout)
        try:
            conn.request("POST", f"{path}?{query}", json.dumps(body),
                         {"Content-Type": "application/json"})
            response = conn.getresponse()
            data = response.read()
        finally:
            conn.close()
        if response.status != 200:
            raise RuntimeError(f"{path}: {response.status} {data[:300]!r}")
        return data


def interact(client: Client, cfg: dict, mix: dict, k: int, cols, label,
             top, bottom) -> Dict:
    """One edit and its playback; -> the interaction's record."""
    mask = column_masks(cfg, cols)[0]
    query = (f"layer=top&temperature={mix['temperature']}&start_index_top=0"
             f"&pitch={label['pitch']}"
             f"&instrument_family_str={label['instrument_family_str']}"
             f"&bench_edit={k}&bench_cols={cols[0]},{cols[1]}")
    t0 = time.perf_counter()
    edited = json.loads(client.post(
        "/timerange-change", query,
        {"top_code": top.tolist(), "bottom_code": bottom.tolist(),
         "mask": mask.tolist()}))
    wav = client.post("/get-audio", "", {"top_code": edited["top_code"],
                                         "bottom_code": edited["bottom_code"]})
    t1 = time.perf_counter()
    return {"edit": k, "cols": cols, "label": label, "top_in": top,
            "bottom_in": bottom,
            "top_out": np.asarray(edited["top_code"], np.int64),
            "bottom_out": np.asarray(edited["bottom_code"], np.int64),
            "pcm": wav_samples(wav), "start": t0, "seconds": t1 - t0}


def start_child(ctx):
    args = {"config": str(ctx.config_path), "seed": ctx.seed,
            "trace": int(ctx.trace), "device": str(ctx.device)}
    if ctx.plant:
        args["plant"] = str(ctx.plant)
    return subprocess.Popen([sys.executable, str(CHILD), json.dumps(args)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, bufsize=1, env=dict(os.environ))


def server_port(proc) -> int:
    line = proc.stdout.readline()
    if not line:
        proc.wait()
        raise RuntimeError(f"the server process ended (code "
                           f"{proc.returncode}) before it served")
    return json.loads(line)["port"]


def command(proc, name: str) -> None:
    proc.stdin.write(name + "\n")
    proc.stdin.flush()
    if proc.stdout.readline().strip() != "ok":
        raise RuntimeError(f"the server process did not answer {name}")


def stop_child(proc) -> dict:
    proc.stdin.write("stop\n")
    proc.stdin.flush()
    record = None
    for line in proc.stdout:
        if line.startswith("BENCH_STATS "):
            record = json.loads(line[len("BENCH_STATS "):])
    proc.wait(timeout=120)
    if record is None:
        raise RuntimeError(f"the server process ended (code "
                           f"{proc.returncode}) without its record")
    return record


def run(ctx) -> dict:
    cfg, mix = ctx.config, ctx.mix
    plan = Plan(cfg, ctx.seed)
    proc = start_child(ctx)
    try:
        ctx.ready()  # this process imports torch while the server starts
        port = server_port(proc)
        log(ctx, "server ready")
        top, bottom = plan.top, plan.bottom
        label = plan.label(0)
        # set-up: one warm edit with a prefix to prime, and its playback
        interact(Client(port, WARMUP_TIMEOUT_S), cfg, mix, -1,
                 tuple(mix["warmup_cols"]), label, top, bottom)
        log(ctx, "warm edit done")
        client = Client(port)
        command(proc, "window_start")
        setup_s = time.perf_counter() - ctx.t_start
        records, failures = [], []
        t0 = time.perf_counter()
        k = 0

        def one():
            nonlocal top, bottom, k
            try:
                rec = interact(client, cfg, mix, k, plan.cols(k),
                               plan.label(k), top, bottom)
                top, bottom = rec["top_out"], rec["bottom_out"]
                return rec
            except (OSError, RuntimeError, ValueError, KeyError) as e:
                failures.append(f"edit {k}: {e!r}")
                return None
            finally:
                k += 1

        while time.perf_counter() - t0 < ctx.seconds:
            rec = one()
            if rec is not None:
                records.append(rec)
        window_s = time.perf_counter() - t0
        command(proc, "window_stop")
        later = []  # the traced decks, and the edits up to their start
        traced = []
        if ctx.trace:
            deck = len(plan.ranges)
            while k % deck:
                later.append(one())
            command(proc, "trace_start")
            for _ in range(int(mix["traced_decks"]) * deck):
                traced.append(one())
            command(proc, "trace_stop")
            later += traced
            later = [r for r in later if r is not None]
            traced = [r for r in traced if r is not None]
        stats = stop_child(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = [r["seconds"] for r in records]
    lat = frozen.percentiles_ms(seconds) or {}
    out = {
        "attempted": k, "failed": len(failures), "failures": failures[:5],
        "end_to_end": {"setup_s": setup_s, "edit_p50_ms": lat.get("p50"),
                       "edit_p95_ms": lat.get("p95")},
        "device": {"kind": stats["device_name"],
                   "memory_peak_bytes": stats["memory_peak_bytes"]},
        "child_modules": stats["modules"],
        "trace": stats["trace"],
        "layer_data": layer_data(cfg, plan, records, stats, window_s),
        "checks": {"interactions": len(records),
                   "traced_slowdown": traced_slowdown(records, traced),
                   "median_ms_by_columns": medians_by_columns(cfg,
                                                              records),
                   "launch_misses": launch_misses(cfg, plan, stats,
                                                  ctx.device),
                   **traced_launches(stats)},
    }
    from harness.edit_check import reference_readings
    readings, control = reference_readings(ctx, records + later)
    out["readings"] = readings
    out["control"] = control
    return out


def medians_by_columns(cfg: dict, records) -> Dict[str, float]:
    """The median interaction, in ms, of each masked column range."""
    out = {}
    for a, b in column_ranges(cfg["top_prior"]["shape"][1]):
        seconds = [r["seconds"] for r in records if r["cols"] == (a, b)]
        if seconds:
            out[f"{a}-{b}"] = float(np.median(seconds)) * 1e3
    return out


def in_window_edits(stats: dict):
    """(edit, edit handle s, playback handle s) of each interaction in the
    window, from the server's record in the order it handled them."""
    out, last = [], None
    for h in stats["handled"]:
        if not h["in_window"]:
            continue
        if h["path"] == "/timerange-change":
            last = h
        elif h["path"] == "/get-audio" and last is not None:
            out.append((last["edit"], last, h))
            last = None
    return out


def launch_misses(cfg: dict, plan: Plan, stats: dict, device):
    """Edits in the window that did not launch the scan once for each prior
    and a prime for each prior whose mask leaves a prefix (the count from
    ``frozen.expected_primes``, not from the server's bucketing). The
    kernels launch on the card alone: None elsewhere."""
    if device.type != "cuda":
        return None
    ratio_t = cfg["bottom_prior"]["shape"][1] // cfg["top_prior"]["shape"][1]
    misses = 0
    for edit, h, _ in in_window_edits(stats):
        want = frozen.expected_primes(
            {"mask": column_masks(cfg, plan.cols(edit))[0]}, ratio_t)
        misses += int(h["scans"] != 2 or h["primes"] != want)
    return misses


def traced_launches(stats: dict) -> dict:
    """The scan and prime kernels the profiler's trace holds beside the
    launches the program's counters made in the traced stretch (a trace
    that missed launches reads the device's idle share too high)."""
    if not stats["trace"]:
        return {}
    counts = stats["trace"]["kernel_counts"]
    traced = [h for h in stats["handled"] if h["traced"]]
    return {f"{kind}_launches_traced": sum(
        n for name, n in counts.items() if f"{kind}_kernel" in name)
        for kind in ("decode_scan", "prefix_prime")} | {
        "decode_scan_launches_counted": sum(h["scans"] for h in traced),
        "prefix_prime_launches_counted": sum(h["primes"] for h in traced)}


def traced_slowdown(window, traced):
    """The profiler's cost: the mean traced interaction over the window's
    mean (None untraced)."""
    if not traced or not window:
        return None
    return (float(np.mean([r["seconds"] for r in traced]))
            / float(np.mean([r["seconds"] for r in window])))


def layer_data(cfg: dict, plan: Plan, records, stats: dict,
               window_s: float) -> dict:
    from harness.edit_check import edit_ops
    client = {r["edit"]: r["seconds"] for r in records}
    http_s, playback_s = [], []
    for edit, h, audio in in_window_edits(stats):
        playback_s.append(audio["handle_s"])
        if edit in client:
            http_s.append(client[edit] - h["handle_s"] - audio["handle_s"])
    bf16 = f32 = 0
    for r in records:
        b, f = edit_ops(cfg, r["cols"])
        bf16 += b
        f32 += f
    return {"http_s": http_s, "playback_s": playback_s,
            "scan_calls": stats["scan_calls"],
            "prime_calls": stats["prime_calls"],
            "ops": {"bf16": bf16, "float32": f32}, "window_s": window_s,
            "trace": stats["trace"], "handled": stats["handled"]}


