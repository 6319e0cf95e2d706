"""The benchmark of odesat_tpu_torch on one NVIDIA H100: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads the cell, warms up its shapes,
measures for ``--seconds``, checks the window's solves against the plain
reference, and prints as its last line of standard output one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit); the same numbers are the last lines of standard error.
It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), or when the process holds ``jax``, ``jaxlib``,
``flax`` or ``odesat_tpu`` once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    from bench_port import harness

    entry = harness.workload_entry(harness.load_manifest(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {entry['chips']} CUDA device(s); torch finds {found}", file=sys.stderr)
        return 2
    try:
        result, checks, notes = harness.run_cell(args.workload, args.seed, args.seconds,
                                                 bool(args.trace), t_start=T_START)
    except ImportError as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    for line in notes:
        print(line)
    print(json.dumps(result))
    sys.stdout.flush()
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
