"""The readings that the limits of ``correct`` are set from: the numbers
compared, on many seeds of the program as it is and of the control (the
program with its own lower-precision path on: ``matmul_dtype="bfloat16"``,
the rounding below the configuration's float32), in one process, each run
with a short window at the cell's own size and load.

    python3 bench_port/control.py --workload <cell> --sound 101 112 --control 201 203 --seconds 3

It prints a line a run and, last, the largest reading of the sound runs
and the smallest of the control's for each number. The benchmark's own
runs do not run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROL = {"matmul_dtype": "bfloat16"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--sound", type=int, nargs=2, metavar=("FIRST", "LAST"), required=True)
    p.add_argument("--control", type=int, nargs=2, metavar=("FIRST", "LAST"), required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from bench_port import harness

    seen = {"sound": {}, "control": {}}
    for kind, (a, b), overrides in (("sound", args.sound, {}), ("control", args.control, CONTROL)):
        for seed in range(a, b + 1):
            result, checks, _ = harness.run_cell(args.workload, seed, args.seconds, False,
                                                 device=args.device, overrides=overrides)
            for k, (v, _lim) in checks.items():
                seen[kind].setdefault(k, []).append(v)
            print(json.dumps({"kind": kind, "seed": seed, "correct": result["correct"],
                              "attempted": result["attempted"], "failed": result["failed"],
                              "checks": result["checks"]}), flush=True)
    print(json.dumps({"workload": args.workload,
                      "sound_max": {k: max(v) for k, v in seen["sound"].items()},
                      "control_min": {k: min(v) for k, v in seen["control"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
