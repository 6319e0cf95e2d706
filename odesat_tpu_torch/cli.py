"""Command-line entry point: ``python -m odesat_tpu_torch {inter,stoch}``.

The port of two subcommands of ``odesat_tpu.cli``:

* ``inter`` (reference: src/main.rs:325-386): no preprocessing; B
  interlaced ODE trajectories, stop when any reaches allsat;
* ``stoch`` (reference: src/main.rs:206-251): preprocess to ratio ``-r``
  (unless ``--no-preprocess``), B chains of the stochastic engine, stop
  when any satisfies every clause, reconstruct the witness through the
  preprocessing trace.

Both verify the readout against the ORIGINAL formula and print
``Checking if solution vector satisfies formula: {true|false}`` with exit
code 0 either way, like the reference. A missing input file, a malformed
formula or a library ``ValueError`` exits 2. The formula is read with the
native parser when its library builds (odesat_tpu_torch/native).

One flag beyond the JAX CLI: ``--device {cuda,cpu}``, default ``cuda``.
Without a CUDA device the CLI stops with an error unless ``--device cpu``
is given: it never moves a run to the CPU on its own. The other
subcommands (solve, batch, hybrid, gen) are not ported yet and exit 2.
"""

from __future__ import annotations

import argparse
import os
import sys

from odesat_tpu_torch.cnf import (
    bandwidth_reorder,
    evaluate_cnf,
    map_values_by_indices,
    normalize_cnf_variables,
    parse_dimacs_file,
    render_variable_map,
)
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig

NOT_PORTED = ("solve", "batch", "hybrid", "gen")


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="odesat_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("inter", help="Run a batch of interlaced simulations")
    p.add_argument("-f", "--input", required=True, help="input DIMACS CNF file")
    p.add_argument("-o", "--output", default=None, help="optional output file")
    p.add_argument("-t", "--tolerance", type=float, default=None)
    p.add_argument("-n", "--step-number", type=int, default=None)
    p.add_argument("-s", "--step-size", type=float, default=None)
    p.add_argument("-b", "--batch-size", type=int, required=True)
    p.add_argument("-l", "--learning-rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=None, help="PRNG seed (reproducible runs)")
    p.add_argument("--chunk-steps", type=int, default=256, help="Euler steps per kernel launch")
    p.add_argument("--rigidity", choices=["paper", "reference"], default="paper")
    p.add_argument(
        "--dv-strategy", choices=["auto", "gather", "segment_sum", "fused"], default="auto",
        help="'fused' is the CUDA chunk kernel; 'auto' takes it for CUDA float32 runs "
        "the kernel supports, else the torch scan path",
    )
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument(
        "--matmul-dtype", choices=["float32", "bfloat16"], default="float32",
        help="chunk-kernel rounding: bfloat16 rounds v and the per-slot "
        "contributions like the TPU kernel's bf16 matmuls",
    )
    p.add_argument("--var-order", choices=["natural", "bandwidth"], default="natural",
                   help="variable layout: 'bandwidth' relabels via reverse Cuthill-McKee")
    p.add_argument(
        "--dt-mode", choices=["per-trajectory", "shared"], default="per-trajectory",
        help="adaptive-dt coupling across the batch: 'shared' adapts one dt from "
        "the batch-max error like the reference inter mode (src/system.rs:314)",
    )
    p.add_argument("--log-every", type=int, default=0, help="chunks between progress logs")
    p.add_argument("--wall-clock-budget", type=float, default=None, help="seconds budget")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the trajectories run (default cuda; no silent CPU fallback)")

    s = sub.add_parser("stoch", help="Run a stochastic search")
    s.add_argument("-f", "--input", required=True, help="input DIMACS CNF file")
    s.add_argument("-o", "--output", default=None, help="optional output file")
    s.add_argument("-n", "--step-number", type=int, default=None)
    s.add_argument("-r", "--ctv-ratio", type=float, default=None,
                   help="preprocessing target clause-to-variable ratio (default 7.0)")
    s.add_argument("-b", "--batch-size", type=int, default=1, help="parallel chains")
    s.add_argument("--seed", type=int, default=None, help="PRNG seed (reproducible runs)")
    s.add_argument("--chunk-steps", type=int, default=256, help="steps per kernel launch")
    s.add_argument(
        "--matmul-dtype", choices=["float32", "bfloat16"], default="float32",
        help="kernel weight sums: bfloat16 rounds each clause weight like the TPU "
        "kernels' bf16 matmuls (clause evaluation stays exact)",
    )
    s.add_argument("--var-order", choices=["natural", "bandwidth"], default="natural",
                   help="variable layout: 'bandwidth' relabels via reverse Cuthill-McKee")
    s.add_argument("--no-preprocess", action="store_true",
                   help="skip the resolution preprocessor")
    s.add_argument("--log-every", type=int, default=0, help="chunks between progress logs")
    s.add_argument("--wall-clock-budget", type=float, default=None, help="seconds budget")
    s.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the chains run (default cuda; no silent CPU fallback)")
    return parser


def _config_from_args(args) -> SolverConfig:
    ode = ODEConfig(
        # `is not None`, not truthiness: an explicit 0 must stick
        tolerance=args.tolerance if args.tolerance is not None else 1e-3,
        step_size=args.step_size,
        steps=args.step_number,
        zeta=args.learning_rate,
        rigidity=args.rigidity,
        dtype=args.dtype,
        dv_strategy=args.dv_strategy,
        matmul_dtype=args.matmul_dtype,
        dt_mode=args.dt_mode,
    )
    return SolverConfig(
        ode=ode,
        preprocess=False,  # inter never preprocesses (src/main.rs:341)
        batch_size=args.batch_size,
        seed=args.seed,
        chunk_steps=args.chunk_steps,
        log_every_chunks=args.log_every,
        wall_clock_budget_s=args.wall_clock_budget,
    )


def _stoch_config(args) -> SolverConfig:
    return SolverConfig(
        ode=ODEConfig(steps=args.step_number, matmul_dtype=args.matmul_dtype),
        ctv_ratio=args.ctv_ratio if args.ctv_ratio is not None else 7.0,
        preprocess=not args.no_preprocess,
        batch_size=args.batch_size,
        seed=args.seed,
        chunk_steps=args.chunk_steps,
        log_every_chunks=args.log_every,
        wall_clock_budget_s=args.wall_clock_budget,
    )


def _or_exit(fn, *args, **kwargs):
    """Run ``fn``; surface a library ValueError as a clean CLI error."""
    try:
        return fn(*args, **kwargs)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from None


def _load(path):
    print("Reading CNF formula from file...")
    if not os.path.exists(path):
        print(f"error: input file not found: {path}", file=sys.stderr)
        raise SystemExit(2)
    print("Parsing CNF formula...")
    from odesat_tpu_torch import native

    if native.is_available():
        try:
            with open(path, "r", encoding="utf-8") as fh:
                return native.parse_dimacs_native(fh.read())
        except ValueError as e:
            # a genuine parse error surfaces; retrying on the Python parser
            # would hide a scanner fault (the two are parity-tested)
            print(f"error: malformed DIMACS in {path}: {e}", file=sys.stderr)
            raise SystemExit(2) from None
        except (OSError, RuntimeError, UnicodeDecodeError):
            pass  # IO or library trouble: the Python parser reads the file itself
    try:
        return parse_dimacs_file(path)
    except ValueError as e:
        print(f"error: malformed DIMACS in {path}: {e}", file=sys.stderr)
        raise SystemExit(2) from None


def _finish(mapped_values: dict, formula, output) -> None:
    """Verify against the ORIGINAL formula, render, write
    (reference: src/main.rs:189-201)."""
    print("Evaluating CNF formula...")
    is_satisfiable = evaluate_cnf(mapped_values, formula)
    print(f"Checking if solution vector satisfies formula: {str(is_satisfiable).lower()}")
    print("Rendering variable assignments...")
    render_str = render_variable_map(mapped_values)
    if output:
        print("Writing results to file...")
        with open(output, "w", encoding="utf-8") as fh:
            fh.write(render_str)
    else:
        print(f"Variable assignments:\n{render_str}")


def _device(name: str):
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        print(
            "error: --device cuda (the default) but torch finds no CUDA device; "
            "pass --device cpu to run the torch scan path on the CPU",
            file=sys.stderr,
        )
        raise SystemExit(2)
    return torch.device(name)


def cmd_inter(args) -> int:
    device = _device(args.device)
    formula = _load(args.input)
    config = _config_from_args(args)

    print("Normalizing CNF formula...")
    var_mapping, normalized = normalize_cnf_variables(formula)
    if args.var_order == "bandwidth":
        var_mapping, normalized = bandwidth_reorder(var_mapping, normalized)

    print("Simulating...")
    from odesat_tpu_torch.models.ode import simulate_batch

    result = _or_exit(simulate_batch, normalized, config, device=device, stop_on="any")
    print(f"Steps run: {result.steps} | trajectories solved: {int(result.done.sum())}"
          f"/{result.done.size} | {result.wall_time_s:.6f} s")

    mapped_values = map_values_by_indices(var_mapping, result.best_assignment())
    _finish(mapped_values, formula, args.output)
    return 0


def _maybe_preprocess(formula, config: SolverConfig):
    """Preprocess unless disabled; returns (reduced formula, trace)."""
    from odesat_tpu_torch.preprocess import SimplificationTrace, preprocess_formula

    if not config.preprocess:
        return formula, SimplificationTrace()
    print("Preprocessing CNF formula...")
    reduced, trace = preprocess_formula(formula, config.ctv_ratio)
    print(f"Clauses: {reduced.num_clauses} | Vars: {reduced.varnum}")
    return reduced, trace


def cmd_stoch(args) -> int:
    device = _device(args.device)
    formula = _load(args.input)
    config = _stoch_config(args)

    reduced, trace = _maybe_preprocess(formula, config)
    var_mapping, normalized = normalize_cnf_variables(reduced)
    if args.var_order == "bandwidth":
        var_mapping, normalized = bandwidth_reorder(var_mapping, normalized)

    print("Simulating...")
    from odesat_tpu_torch.models.stoch import search

    result = _or_exit(search, normalized, config, device=device)
    print(f"Steps run: {result.steps} | chains solved: {int(result.done.sum())}"
          f"/{result.done.size} | {result.wall_time_s:.6f} s")

    print("Mapping values...")
    from odesat_tpu_torch.preprocess import reconstruct_witness

    mapped_values = map_values_by_indices(var_mapping, result.best_assignment())
    reconstruct_witness(mapped_values, trace)
    _finish(mapped_values, formula, args.output)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"error: '{argv[0]}' is not yet ported to odesat_tpu_torch "
              "(only 'inter' and 'stoch' are); use python -m odesat_tpu", file=sys.stderr)
        return 2
    args = _build_parser().parse_args(argv)
    return cmd_stoch(args) if args.cmd == "stoch" else cmd_inter(args)


if __name__ == "__main__":
    sys.exit(main())
