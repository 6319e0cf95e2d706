"""The uf250 time-to-solution protocol on the card: the port of the JAX
package's ``tools/uf250_tts.py``.

A wall clock mixes the solver with the host, so the protocol
(``utils/tts.py``) splits it:

* **steps to solution** per instance, deterministic for the seed and exact
  (the final chunk is bisected);
* **compute time** = steps x batch / the steady-state kernel rate, measured
  here at the uf250 shape (``utils/timing.measure_throughput``);
* **dispatch share** = chunks x the measured launch round trip;
* the **residual** (wall - compute - dispatch): the host's share, reported
  rather than absorbed.

Usage, on a machine with a CUDA card:

    python -m odesat_tpu_torch.tools.uf250_tts [n_instances] [batch] [chunk]
        [--budget N] [--matmul-dtype bfloat16|float32] [--device cuda|cpu]

Instance i is ``uf_instance(250, seed=i)`` at fixed dt=0.01, its initial
state drawn from a generator seeded with i, through the resident chunk
kernel B1 on CUDA.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the device."""
    if torch.device(device).type != "cuda":
        return str(device)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(torch.device(device))


def measure(n_instances: int = 20, batch: int = 4096, chunk: int = 64, budget: int = 20000,
            matmul_dtype: str = "bfloat16", device="cuda", first_seed: int = 0) -> dict:
    """The protocol over instances ``first_seed .. first_seed + n_instances
    - 1``: returns ``{"dispatch_s", "rate", "rows"}``, a row per instance
    ``(seed, ExactSolve, verified, breakdown)``."""
    from odesat_tpu_torch.cnf import compile_formula, evaluate_cnf, normalize_cnf_variables
    from odesat_tpu_torch.models.ode import formula_device, init_state, make_chunk_runner
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.generate import uf_instance
    from odesat_tpu_torch.utils.timing import measure_throughput
    from odesat_tpu_torch.utils.tts import (
        evict_formula,
        measure_dispatch_latency,
        solve_exact,
        tts_breakdown,
    )

    device = torch.device(device)
    dispatch_s = measure_dispatch_latency(device=device)
    ode = ODEConfig(step_size=0.01, matmul_dtype=matmul_dtype)
    # the steady-state kernel rate at the uf250 shape
    _, norm0 = normalize_cnf_variables(uf_instance(250, seed=first_seed))
    fa = compile_formula(norm0)
    runner = make_chunk_runner(fa, ode.resolve_zeta(fa.density), ode, 2000, device)
    st = init_state(fa, batch, torch.Generator(device=device).manual_seed(0), ode, device)
    rate, _ = measure_throughput(runner, st, formula_device(fa, device), 2000, batch, iters=3)

    cache: dict = {}
    rows = []
    for seed in range(first_seed, first_seed + n_instances):
        _, norm = normalize_cnf_variables(uf_instance(250, seed=seed))
        fa_i = compile_formula(norm)
        res = solve_exact(fa_i, ode, batch, torch.Generator(device=device).manual_seed(seed),
                          chunk, budget, runner_cache=cache, readout=True, device=device)
        # assignment[i] is normalized variable i (dense 0-based indices)
        verified = bool(res.solved and evaluate_cnf(
            {i: bool(a) for i, a in enumerate(res.assignment)}, norm))
        rows.append((seed, res, verified,
                     tts_breakdown(res.steps, res.chunks, batch, rate, dispatch_s, res.wall_s)))
        evict_formula(cache, fa_i)  # each instance is a new formula object
    return {"dispatch_s": dispatch_s, "rate": rate, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_instances", nargs="?", type=int, default=20)
    ap.add_argument("batch", nargs="?", type=int, default=4096)
    ap.add_argument("chunk", nargs="?", type=int, default=64)
    ap.add_argument("--budget", type=int, default=20000)
    ap.add_argument("--matmul-dtype", choices=["float32", "bfloat16"], default="bfloat16")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda (the default) but torch finds no CUDA device")
    card = card_name(args.device)
    out = measure(args.n_instances, args.batch, args.chunk, args.budget, args.matmul_dtype,
                  args.device)
    print(f"card: {card}")
    print(f"dispatch+sync round trip: median {out['dispatch_s'] * 1e3:.6f} ms (over 15)")
    print(f"steady-state kernel rate at B={args.batch}: {out['rate']:.6e} traj*steps/s")
    print(f"\n{'seed':>4} {'solved':>6} {'verif':>5} {'steps':>6} {'chunks':>6} {'wall s':>9} "
          f"{'compute s':>9} {'dispatch s':>10} {'residual s':>10}")
    for seed, res, verified, bd in out["rows"]:
        print(f"{seed:>4} {str(res.solved):>6} {str(verified):>5} {bd['steps']:>6} "
              f"{res.chunks:>6} {bd['wall_s']:>9.6f} {bd['compute_s']:>9.6f} "
              f"{bd['dispatch_s']:>10.6f} {bd['residual_s']:>10.6f}")
    solved = [r for r in out["rows"] if r[1].solved]
    print(f"\nsolved {len(solved)}/{args.n_instances} (all verified: "
          f"{all(r[2] for r in solved)})")
    if solved:
        steps = np.array([r[3]["steps"] for r in solved])
        walls = np.array([r[3]["wall_s"] for r in solved])
        comps = np.array([r[3]["compute_s"] for r in solved])
        resid = np.array([r[3]["residual_s"] for r in solved])
        print(f"steps-to-solution (exact): median {np.median(steps):.0f}, "
              f"p90 {np.percentile(steps, 90):.0f}, max {steps.max()}, min {steps.min()}")
        print(f"compute TTS: median {np.median(comps) * 1e3:.6f} ms; wall TTS: median "
              f"{np.median(walls) * 1e3:.6f} ms, max {walls.max() * 1e3:.6f} ms; residual: "
              f"median {np.median(resid) * 1e3:.6f} ms ({card})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
