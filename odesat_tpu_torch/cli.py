"""Command-line entry point: ``python -m odesat_tpu_torch {solve,batch,inter,stoch,gen}``.

The port of five subcommands of ``odesat_tpu.cli``:

* ``solve`` (reference: src/main.rs:143-204): preprocess to ratio ``-r``
  (unless ``--no-preprocess``), race ``--solve-batch`` ODE trajectories,
  stop when any reaches allsat, reconstruct the witness through the
  preprocessing trace;
* ``batch`` (reference: src/main.rs:253-323): no preprocessing; B random
  restarts in parallel, stop at the first trajectory whose readout the
  oracle verifies, with a ``\r`` progress line per chunk;
* ``inter`` (reference: src/main.rs:325-386): no preprocessing; B
  interlaced ODE trajectories, stop when any reaches allsat;
* ``stoch`` (reference: src/main.rs:206-251): preprocess like ``solve``,
  B chains of the stochastic engine, stop when any satisfies every clause;
* ``gen``: write a random CNF instance (utils/generate.py).

The solvers verify the readout against the ORIGINAL formula and print
``Checking if solution vector satisfies formula: {true|false}`` with exit
code 0 either way, like the reference. A missing input file, a malformed
formula or a library ``ValueError`` exits 2. The formula is read with the
native parser when its library builds (odesat_tpu_torch/native).

Flags beyond the JAX CLI: ``--device {cuda,cpu}``, default ``cuda``.
Without a CUDA device the CLI stops with an error unless ``--device cpu``
is given: it never moves a run to the CPU on its own. ``--dist-backend
{nccl,gloo}`` (default ``nccl``) goes with the mesh flags ``--devices T``
and ``--clause-shards S`` of ``solve``, ``batch``, ``inter`` and ``stoch``:
with ``T*S > 1`` the CLI spawns one rank per process
(``parallel/launch.py``), the solve runs on every rank, and the parent
prints rank 0's result, with the same lines and exit codes; a failed worker
makes the CLI exit non-zero. NCCL takes one card per rank; ranks that share
a card (or run on the CPU) need ``gloo``, which the caller chooses.
``--shard-chunk {auto,on,off}`` picks the clause mesh's kernels as in the
JAX CLI (a bare flag means ``on``). ``--pod-mesh``, ``--coordinator``,
checkpoint, resume and profile flags are not ported and not accepted; the ``hybrid``
subcommand is not ported yet and exits 2.
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

NOT_PORTED = ("hybrid",)
DV_STRATEGIES = ["auto", "gather", "segment_sum", "fused", "stream", "pallas"]


def _add_ode(p: argparse.ArgumentParser, batch_required: bool) -> None:
    """The flags of the ODE subcommands (solve, batch, inter)."""
    p.add_argument("-f", "--input", required=True, help="input DIMACS CNF file")
    p.add_argument("-o", "--output", default=None, help="optional output file")
    p.add_argument("-t", "--tolerance", type=float, default=None)
    p.add_argument("-n", "--step-number", type=int, default=None, required=batch_required)
    p.add_argument("-s", "--step-size", type=float, default=None)
    if batch_required:
        p.add_argument("-b", "--batch-size", type=int, required=True)
    p.add_argument("-l", "--learning-rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=None, help="PRNG seed (reproducible runs)")
    p.add_argument("--chunk-steps", type=int, default=256, help="Euler steps per kernel launch")
    p.add_argument("--rigidity", choices=["paper", "reference"], default="paper")
    p.add_argument(
        "--dv-strategy", choices=DV_STRATEGIES, default="auto",
        help="'fused' and 'stream' are the CUDA chunk kernels (resident, and for "
        "formulas past the resident kernel's gate), 'pallas' single steps through "
        "the CUDA RHS kernel; 'auto' takes fused, then stream, for CUDA float32 "
        "runs, else the torch scan path",
    )
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument(
        "--matmul-dtype", choices=["float32", "bfloat16"], default="float32",
        help="chunk-kernel rounding: bfloat16 rounds v and the per-slot "
        "contributions like the TPU kernel's bf16 matmuls",
    )
    p.add_argument("--var-order", choices=["natural", "bandwidth"], default="natural",
                   help="variable layout: 'bandwidth' relabels via reverse Cuthill-McKee")
    p.add_argument("--log-every", type=int, default=0, help="chunks between progress logs")
    p.add_argument("--wall-clock-budget", type=float, default=None, help="seconds budget")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the trajectories run (default cuda; no silent CPU fallback)")
    _add_mesh(p)


def _add_mesh(p: argparse.ArgumentParser) -> None:
    p.add_argument("--devices", type=int, default=1, help="ranks on the trajectory mesh axis")
    p.add_argument("--clause-shards", type=int, default=1, help="ranks on the clause mesh axis")
    p.add_argument(
        "--dist-backend", choices=["nccl", "gloo"], default="nccl",
        help="torch.distributed backend of a mesh run: nccl needs one card per rank; "
        "gloo serves ranks that share a card, and --device cpu",
    )
    p.add_argument(
        "--shard-chunk", nargs="?", const="on", default="auto", choices=("auto", "on", "off"),
        help="clause mesh kernels: the clause-sharded chunk (B6 for the ODE, B9 for stoch, "
        "the update after each all-reduce in the next launch) or the per-step path ('off': B5 "
        "or B8, the update in torch). Default 'auto' takes the chunk where eligible; a bare "
        "--shard-chunk forces it on",
    )


def _add_dt_mode(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--dt-mode", choices=["per-trajectory", "shared"], default="per-trajectory",
        help="adaptive-dt coupling across the batch: 'shared' adapts one dt from "
        "the batch-max error like the reference inter mode (src/system.rs:314)",
    )


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="odesat_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    solve = sub.add_parser("solve", help="Run a single simulation")
    _add_ode(solve, batch_required=False)
    solve.add_argument("-r", "--ctv-ratio", type=float, default=None,
                       help="preprocessing target clause-to-variable ratio (default 7.0)")
    solve.add_argument(
        "--solve-batch", type=int, default=8, metavar="B",
        help="race B random initializations and return the first winner "
        "(pass 1 for the reference's single-trajectory solve)",
    )
    solve.add_argument("--no-preprocess", action="store_true",
                       help="skip the resolution preprocessor")

    batch = sub.add_parser("batch", help="Run a batch of simulations (parallel restarts)")
    _add_ode(batch, batch_required=True)
    _add_dt_mode(batch)

    p = sub.add_parser("inter", help="Run a batch of interlaced simulations")
    _add_ode(p, batch_required=False)
    p.add_argument("-b", "--batch-size", type=int, required=True)
    _add_dt_mode(p)
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
    _add_mesh(s)

    gen = sub.add_parser("gen", help="Generate a random CNF instance (benchmark families)")
    gen.add_argument("-o", "--output", required=True, help="output DIMACS file")
    gen.add_argument("-n", "--n-vars", type=int, required=True)
    gen.add_argument("-m", "--n-clauses", type=int, default=None,
                     help="default: round(4.26 * n)")
    gen.add_argument("-k", "--clause-width", type=int, default=3)
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("--planted", action="store_true",
                     help="plant a hidden satisfying assignment (guaranteed SAT)")
    gen.add_argument("--locality", type=int, default=None,
                     help="draw each clause's variables from a window this wide "
                     "(locally-structured instances; implies --planted)")
    return parser


def _config_from_args(args, batch_size: int) -> SolverConfig:
    """The ODE subcommands' config; only ``solve`` preprocesses."""
    ratio = getattr(args, "ctv_ratio", None)
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
        dt_mode=getattr(args, "dt_mode", "per-trajectory"),
        shard_chunk=args.shard_chunk,
    )
    return SolverConfig(
        ode=ode,
        ctv_ratio=ratio if ratio is not None else 7.0,
        # batch and inter never preprocess (src/main.rs:269,341)
        preprocess=args.cmd == "solve" and not args.no_preprocess,
        batch_size=batch_size,
        seed=args.seed,
        chunk_steps=args.chunk_steps,
        log_every_chunks=args.log_every,
        wall_clock_budget_s=args.wall_clock_budget,
    )


def _stoch_config(args) -> SolverConfig:
    return SolverConfig(
        ode=ODEConfig(steps=args.step_number, matmul_dtype=args.matmul_dtype,
                      shard_chunk=args.shard_chunk),
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


def _mesh_solve(mesh, device, engine, problem, config, kwargs):
    """The engine's solve on one device (``mesh`` None), or a rank's part
    of a mesh run (parallel/launch.spawn calls it in every worker; rank
    0's result is the parent's)."""
    if engine == "stoch":
        from odesat_tpu_torch.models.stoch import search

        return search(problem, config, device=device, mesh=mesh, **kwargs)
    from odesat_tpu_torch.models.ode import simulate_batch

    return simulate_batch(problem, config, device=device, mesh=mesh, **kwargs)


def _solve(args, engine, normalized, config, device, **kwargs):
    """Run the engine on one device, or spawn a ``--devices x
    --clause-shards`` mesh and return rank 0's result."""
    T, S = args.devices, args.clause_shards
    if T < 1 or S < 1:
        print(f"error: --devices and --clause-shards must be at least 1, not {T} and {S}",
              file=sys.stderr)
        raise SystemExit(2)
    if args.shard_chunk == "on" and S <= 1:
        print("error: --shard-chunk requires --clause-shards >= 2 (it is the clause mesh's "
              "kernel)", file=sys.stderr)
        raise SystemExit(2)
    if T * S == 1:
        return _or_exit(_mesh_solve, None, device, engine, normalized, config, kwargs)
    import dataclasses
    from types import SimpleNamespace

    from odesat_tpu_torch.cnf import FormulaArrays
    from odesat_tpu_torch.parallel.launch import spawn
    from odesat_tpu_torch.parallel.sharded import compile_for_mesh

    if config.seed is None:  # every rank must draw the same numbers
        config = dataclasses.replace(config, seed=int.from_bytes(os.urandom(4), "little"))
    problem = normalized
    if not isinstance(normalized, FormulaArrays):  # compiled once, here
        problem = _or_exit(compile_for_mesh, normalized, config, SimpleNamespace(n_clause=S),
                           engine)
    return _or_exit(spawn, _mesh_solve, T, S, args.dist_backend, device.type,
                    args=(engine, problem, config, kwargs))


class _BatchHarvest:
    """``batch``'s oracle-verified early exit (src/main.rs:302-307), as a
    picklable callable so that mesh ranks can run it: it returns the mapping
    it verified, which stops the run and comes back in the result
    (``SolveResult.harvested``), else False. Only the primary rank prints
    the progress line."""

    def __init__(self, formula, var_mapping, n_vars):
        self.formula, self.var_mapping, self.n_vars = formula, var_mapping, n_vars

    def __call__(self, state, done):
        from odesat_tpu_torch.parallel.dist import is_primary

        # the \r progress line stands for the reference's per-trial line
        # (src/main.rs:279)
        if is_primary():
            print(f"\rRunning batch: {int(done.sum())}/{done.size} trajectories converged",
                  end="", flush=True)
        converged = done.nonzero()[0]
        if converged.size:
            readout = (state.v[:, : self.n_vars] > 0.0).cpu().numpy()
            for idx in converged:
                mapped = map_values_by_indices(self.var_mapping, readout[idx])
                if evaluate_cnf(mapped, self.formula):
                    return mapped
        return False


def _normalize(formula, args):
    """Normalize (and optionally relabel) a formula; prints nothing."""
    var_mapping, normalized = normalize_cnf_variables(formula)
    if args.var_order == "bandwidth":
        var_mapping, normalized = bandwidth_reorder(var_mapping, normalized)
    return var_mapping, normalized


def _steps_line(result, what: str = "trajectories") -> None:
    print(f"Steps run: {result.steps} | {what} solved: {int(result.done.sum())}"
          f"/{result.done.size} | {result.wall_time_s:.6f} s")


def cmd_solve(args) -> int:
    device = _device(args.device)
    formula = _load(args.input)
    # race a micro-batch of random inits; the reference solve draws one
    # (src/system.rs:171), and the first winner keeps its contract
    config = _config_from_args(args, batch_size=max(1, args.solve_batch))

    reduced, trace = _maybe_preprocess(formula, config)
    var_mapping, normalized = _normalize(reduced, args)

    print("Simulating...")
    if args.devices > 1:
        import dataclasses

        # the micro-batch must split evenly over the trajectory axis
        config = dataclasses.replace(
            config, batch_size=-(-config.batch_size // args.devices) * args.devices)
    result = _solve(args, "ode", normalized, config, device)
    _steps_line(result)

    print("Mapping values...")
    from odesat_tpu_torch.preprocess import reconstruct_witness

    mapped_values = map_values_by_indices(var_mapping, result.best_assignment())
    reconstruct_witness(mapped_values, trace)
    _finish(mapped_values, formula, args.output)
    return 0


def cmd_batch(args) -> int:
    device = _device(args.device)
    formula = _load(args.input)
    config = _config_from_args(args, batch_size=args.batch_size)

    print("Normalizing CNF formula...")
    var_mapping, normalized = _normalize(formula, args)

    print("Simulating...")
    from odesat_tpu_torch.cnf import compile_formula

    problem = normalized
    if args.clause_shards == 1:
        # the JAX CLI's layout for batch: no width buckets (a clause mesh
        # compiles for the mesh)
        problem = compile_formula(normalized, clause_pad=config.clause_pad,
                                  var_pad=config.var_pad)
    harvest = _BatchHarvest(formula, var_mapping, normalized.varnum)
    result = _solve(args, "ode", problem, config, device, stop_on="all", harvest=harvest)
    if result.steps:
        print()  # end the \r progress line (one per chunk)
    _steps_line(result)

    verified = {"mapped": result.harvested} if result.harvested is not None else {}
    if "mapped" not in verified:
        # budget exhausted: check every readout like the reference checks
        # every trial (verified or not, the last mapping is kept)
        mapped = {}
        for row in result.assignment:
            mapped = map_values_by_indices(var_mapping, row)
            if evaluate_cnf(dict(mapped), formula):
                verified["mapped"] = mapped
                break
        verified.setdefault("mapped", mapped)
    _finish(verified["mapped"], formula, args.output)
    return 0


def cmd_inter(args) -> int:
    device = _device(args.device)
    formula = _load(args.input)
    config = _config_from_args(args, batch_size=args.batch_size)

    print("Normalizing CNF formula...")
    var_mapping, normalized = _normalize(formula, args)

    print("Simulating...")
    result = _solve(args, "ode", normalized, config, device, stop_on="any")
    _steps_line(result)

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
    var_mapping, normalized = _normalize(reduced, args)

    print("Simulating...")
    result = _solve(args, "stoch", normalized, config, device)
    _steps_line(result, "chains")

    print("Mapping values...")
    from odesat_tpu_torch.preprocess import reconstruct_witness

    mapped_values = map_values_by_indices(var_mapping, result.best_assignment())
    reconstruct_witness(mapped_values, trace)
    _finish(mapped_values, formula, args.output)
    return 0


def cmd_gen(args) -> int:
    from odesat_tpu_torch.cnf import cnf_to_dimacs
    from odesat_tpu_torch.utils.generate import random_ksat, random_local_ksat

    m = args.n_clauses if args.n_clauses is not None else int(round(4.26 * args.n_vars))
    # a narrow --locality surfaces as the generator's ValueError
    if args.locality is not None:
        formula = _or_exit(random_local_ksat, args.n_vars, m, k=args.clause_width,
                           locality=args.locality, seed=args.seed, planted=True)
    else:
        formula = _or_exit(random_ksat, args.n_vars, m, k=args.clause_width, seed=args.seed,
                           planted=args.planted)
    with open(args.output, "w", encoding="utf-8") as fh:
        fh.write(cnf_to_dimacs(formula))
    print(f"wrote {args.output}: {formula.varnum} vars, {formula.num_clauses} clauses")
    return 0


COMMANDS = {"solve": cmd_solve, "batch": cmd_batch, "inter": cmd_inter, "stoch": cmd_stoch,
            "gen": cmd_gen}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"error: '{argv[0]}' is not yet ported to odesat_tpu_torch "
              f"(only {', '.join(COMMANDS)} are); use python -m odesat_tpu", file=sys.stderr)
        return 2
    args = _build_parser().parse_args(argv)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
