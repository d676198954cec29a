"""Readings of the comparison that decides ``correct``, for setting its
limits: the program's readings and the control's over many seeds, in one
process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10 [--fault <name>] [--out chiprun_out/calibrate.jsonl]

Each seed runs the cell as ``run.py`` does (``--trace 0``) and also reads
the control: the plain reference computed in the precision below the one
the configuration states (the serving cell's bfloat16 sampling: float8
e4m3, and its float32 playback: TF32; the training cell's float32 with
TF32 off: TF32). ``--fault`` plants one of ``harness/faults.py``'s faults
in the program instead. The control's readings go through the same
comparison as the program's (``control_correct``, which has to be false).
A limit goes above the program's largest reading and below the smallest
of the control's and the faults'. Prints one JSON line a seed; the
benchmark's own runs never run the control or a fault.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--fault", default=None,
                   help="a fault of harness/faults.py to plant")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(1, str(run.ROOT))
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            result = run.run_cell(
                args.workload, seed, args.seconds, False, "cuda",
                control=args.fault is None, t_start=t_start,
                plant=args.fault and f"harness.faults:{args.fault}")
        except Exception as e:  # noqa: BLE001 — report and go on
            traceback.print_exc()
            print(json.dumps({"seed": seed, "error": repr(e)}), flush=True)
            continue
        line = json.dumps({
            "seed": seed, "fault": args.fault, "correct": result["correct"],
            "attempted": result["attempted"], "failed": result["failed"],
            "program": {k: v["value"] for k, v in
                        result["compared"].items()},
            "control_correct": result.get("control_correct"),
            "control": {k: v["value"] for k, v in
                        result.get("control_compared", {}).items()},
            "metrics": result["metrics"],
            "checks": result["checks"]})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
