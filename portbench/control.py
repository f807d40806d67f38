"""The control of ``correct``: runs a cell's whole pipeline (set-up, a
window of solves, the judge) with the program's own lower-precision path
switched on, ``dtype="float32"`` (the configurations state float64), on
several seeds in one process, and prints each seed's readings beside the
configuration's limits.  Every reading that exceeds its limit shows the
judge failing the control; the benchmark's own runs never run this.

    python3 portbench/control.py --workload neuma1-128.mf --seeds 11,12,13 --seconds 10
    python3 portbench/control.py ... --dtype float64   # the sound program, same output

It needs the card.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from portbench.harness import BenchError, run_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            res, checks = run_cell(ROOT, args.workload, seed, args.seconds, False,
                                   option_overrides={"dtype": args.dtype})
        except BenchError as exc:
            print(json.dumps({"seed": seed, "dtype": args.dtype, "error": str(exc)}), flush=True)
            continue
        print(json.dumps({"seed": seed, "dtype": args.dtype, "correct": res["correct"],
                          "attempted": res["attempted"], "failed": res["failed"],
                          "checks": checks}), flush=True)
