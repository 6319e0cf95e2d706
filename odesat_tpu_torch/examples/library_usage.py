"""Library API tour of the PyTorch port: everything the CLI does,
programmatically (the counterpart of the JAX package's
examples/library_usage.py).

Run from the root of a checkout:

    python odesat_tpu_torch/examples/library_usage.py [path/to/file.cnf] [--device cpu]

``--device`` defaults to cuda (one H100; the CUDA kernels build on first
use); ``--device cpu`` runs the torch paths on the CPU.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import odesat_tpu_torch as ot  # noqa: E402  (imports no torch until a name is used)


def sharded_solve(mesh, device, normalized, config, engine):
    """One rank's part of a mesh solve: ``parallel.launch.spawn`` runs it on
    every rank, and the result holds the global batch on each."""
    if engine == "stoch":
        return ot.search(normalized, config, device=device, mesh=mesh)
    from odesat_tpu_torch.parallel import simulate_batch_sharded

    return simulate_batch_sharded(normalized, config, mesh, device=device)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", nargs="?", default="tests/data/easy.cnf")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args()
    device = args.device
    # on the CPU the torch twin runs: smaller batches, and shorter chunks,
    # since a solve stops at the end of the chunk that holds a solution
    small = device == "cpu"
    chunk = 32 if small else 256

    # 1. parse + preprocess (native C++ when it builds) + normalize
    with open(args.path, encoding="utf-8") as fh:
        formula = ot.parse_dimacs(fh.read())
    reduced, trace = ot.preprocess_formula(formula, target_ratio=7.0)
    var_mapping, normalized = ot.normalize_cnf_variables(reduced)
    print(f"{formula.num_clauses} clauses / {formula.varnum} vars "
          f"-> {reduced.num_clauses} / {reduced.varnum} after preprocessing")

    # 2. batched ODE solve (the resident CUDA chunk kernel B1 on a card)
    config = ot.SolverConfig(
        ode=ot.ODEConfig(steps=20_000),  # adaptive step, tolerance 1e-3
        batch_size=32 if small else 1024,
        seed=0,
        chunk_steps=chunk,
    )
    result = ot.simulate_batch(normalized, config, device=device)
    print(f"solved={result.any_solved} after {result.steps} steps "
          f"in {result.wall_time_s:.2f}s ({result.done.sum()} trajectories)")

    # 3. map back through normalization + witness reconstruction, then verify
    assignment = ot.cnf.map_values_by_indices(var_mapping, result.best_assignment())
    ot.reconstruct_witness(assignment, trace)
    verified = ot.evaluate_cnf(assignment, formula)
    print("verified:", verified)

    # 4. the stochastic engine on the same formula
    stoch_result = ot.search(normalized, ot.SolverConfig(
        ode=ot.ODEConfig(steps=100_000), batch_size=32 if small else 256, seed=1,
        chunk_steps=chunk), device=device)
    print("stoch solved:", stoch_result.solved_index is not None)

    # 5. multi-device: a rank a process (one a card under nccl; gloo for
    # ranks that share a card or run on the CPU). One spawned world of two
    # ranks runs a trajectory mesh (2x1) for each engine and a clause mesh
    # (1x2), whose clause arrays compile_for_mesh lays out as shard
    # segments summed every step; a multi-host job passes
    # pod=initialize_distributed(coordinator=..., num_processes=...,
    # process_id=...) to spawn on every host (see the README)
    from odesat_tpu_torch.parallel import launch

    import torch

    backend = "nccl" if device == "cuda" and torch.cuda.device_count() > 1 else "gloo"
    mesh_config = ot.SolverConfig(ode=ot.ODEConfig(steps=20_000), batch_size=32 if small else 128,
                                   seed=2, chunk_steps=chunk)
    ode, stoch, clause = launch.spawn(launch.run_all, 1, 2, backend, device, args=([
        (launch.on_mesh, ((2, 1), sharded_solve, normalized, mesh_config, "ode")),
        (launch.on_mesh, ((2, 1), sharded_solve, normalized, mesh_config, "stoch")),
        (sharded_solve, (normalized, mesh_config, "ode")),
    ],))
    print("sharded solve:", ode.any_solved)
    print("sharded stoch:", stoch.solved_index is not None)
    print("clause-sharded solve:", clause.any_solved)

    # 6. serving: same-shape instances reuse the kernels (each CUDA source
    # is built once into odesat_tpu_torch/csrc/_build and loaded once a
    # process; there is no XLA compilation cache to enable)
    from odesat_tpu_torch.utils.generate import uf_instance

    for seed in range(3):
        _, inst = ot.normalize_cnf_variables(uf_instance(100, seed=seed))
        r = ot.simulate_batch(inst, ot.SolverConfig(
            ode=ot.ODEConfig(step_size=0.01, steps=5000), batch_size=16 if small else 512,
            seed=seed, chunk_steps=chunk), device=device)
        print(f"instance {seed}: solved={r.any_solved} in {r.wall_time_s:.2f}s"
              + (" (build and load)" if seed == 0 else " (loaded kernel)"))
    return 0 if verified else 1


if __name__ == "__main__":
    sys.exit(main())
