"""Concurrent load test for the inpainting server (locustfile.py parity).

The reference ships a locust harness (reference ``locustfile.py:20-44``)
with a recorded realistic payload (full top/bottom codemaps + mask +
conditioning) and tasks weighted toward ``/get-spectrogram-image`` with
``/timerange-change`` and ``/get-audio`` defined. This is a
dependency-free thread-pool driver (stdlib and numpy) with the same
request mix and payload shape, reporting p50/p95 latency and request
throughput per endpoint. A request that fails (a 4xx or 5xx status, a
refused connection, a timeout) counts as an error of its endpoint and is
logged with its reason. ``ramp_s`` starts the users evenly over the
window's first seconds (locust's spawn rate) instead of all at once. The
port's own copy of the JAX package's module.

Usage, against ``isi-server-torch --test_models full --warmup``:
    python -m interactive_spectrogram_inpainting_tpu_torch.serve.loadtest \
        --host http://localhost:5000 --users 32 --duration 60 --ramp 8
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import threading
import time
import urllib.request
from collections import defaultdict
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)


def make_payload(top_shape=(32, 4), bottom_shape=(64, 8), vocab=512,
                 long_factor: int = 1):
    """Realistic request payload (reference locustfile.py:4-17).
    ``long_factor > 1`` emits a sound of that multiple of the model
    duration (the NOTONO long-sound path: windowing + time-index
    remapping server-side)."""
    rng = np.random.default_rng()
    mask = np.zeros(top_shape, bool)
    t0 = rng.integers(0, top_shape[1] - 1)
    mask[:, t0:t0 + 2] = True
    t_top = top_shape[1] * long_factor
    t_bottom = bottom_shape[1] * long_factor
    cond = {
        "pitch": [[60] * t_top] * top_shape[0],
        "instrument_family_str": [["keyboard"] * t_top] * top_shape[0],
    }
    cond_b = {
        "pitch": [[60] * t_bottom] * bottom_shape[0],
        "instrument_family_str": [["keyboard"] * t_bottom]
        * bottom_shape[0],
    }
    return {
        "top_code": rng.integers(
            0, vocab, (top_shape[0], t_top)).tolist(),
        "bottom_code": rng.integers(
            0, vocab, (bottom_shape[0], t_bottom)).tolist(),
        "mask": mask.tolist(),
        "top_conditioning": cond,
        "bottom_conditioning": cond_b,
    }


# (path, query, weight); mirrors the reference's task weighting
TASKS = [
    ("/get-spectrogram-image", "", 3),
    ("/get-audio", "", 1),
    ("/timerange-change",
     "?layer=top&temperature=1.0&start_index_top=0&pitch=60"
     "&instrument_family_str=keyboard", 1),
]


def run_load(host: str, users: int, duration_s: float,
             top_shape=(32, 4), bottom_shape=(64, 8), vocab=512,
             long_fraction: float = 0.0, ramp_s: float = 0.0
             ) -> Dict[str, Dict[str, float]]:
    """``long_fraction``: probability that a /timerange-change request
    carries a 2x-duration sound (windowed at a random start index) —
    the long-sound serving path. ``ramp_s``: user ``i`` sends its first
    request ``i * ramp_s / users`` seconds into the window (0: all at
    once)."""
    latencies: Dict[str, List[float]] = defaultdict(list)
    errors: Dict[str, int] = defaultdict(int)
    lock = threading.Lock()
    stop = threading.Event()
    weighted = [t for t in TASKS for _ in range(t[2])]

    def user(delay):
        if stop.wait(delay):
            return
        while not stop.is_set():
            path, query, _ = random.choice(weighted)
            label = path
            long = (path == "/timerange-change"
                    and random.random() < long_fraction)
            payload = make_payload(top_shape, bottom_shape, vocab,
                                   long_factor=2 if long else 1)
            if long:
                start = random.randint(0, top_shape[1])
                query = query.replace("start_index_top=0",
                                      f"start_index_top={start}")
                label = path + " (long2x)"
            req = urllib.request.Request(
                host + path + query, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    r.read()
                dt = time.perf_counter() - t0
                with lock:
                    latencies[label].append(dt)
            except Exception as exc:  # noqa: BLE001 - every failure counts
                logger.warning("%s failed: %r", label, exc)
                with lock:
                    errors[label] += 1
            # reference users wait 1-8 s between requests
            stop.wait(random.uniform(1.0, 8.0))

    threads = [threading.Thread(target=user, args=(i * ramp_s / users,),
                                daemon=True)
               for i in range(users)]
    start = time.time()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    elapsed = time.time() - start

    report = {}
    for path, times in latencies.items():
        arr = np.asarray(times)
        report[path] = {
            "requests": len(arr),
            "errors": errors.get(path, 0),
            "p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 1),
            "p95_ms": round(float(np.percentile(arr, 95)) * 1e3, 1),
            "rps": round(len(arr) / elapsed, 3),
        }
    for path, count in errors.items():
        report.setdefault(path, {"requests": 0})["errors"] = count
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", type=str, default="http://localhost:5000")
    p.add_argument("--users", type=int, default=4)
    p.add_argument("--duration", type=float, default=60.0)
    p.add_argument("--top_shape", type=int, nargs=2, default=[32, 4])
    p.add_argument("--bottom_shape", type=int, nargs=2, default=[64, 8])
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--long_fraction", type=float, default=0.0,
                   help="fraction of /timerange-change requests carrying "
                        "a 2x-duration sound (long-sound path)")
    p.add_argument("--ramp", type=float, default=0.0,
                   help="seconds over which the users start (0: at once)")
    args = p.parse_args(argv)
    report = run_load(args.host, args.users, args.duration,
                      tuple(args.top_shape), tuple(args.bottom_shape),
                      args.vocab, long_fraction=args.long_fraction,
                      ramp_s=args.ramp)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
