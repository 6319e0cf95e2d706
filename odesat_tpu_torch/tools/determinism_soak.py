"""Determinism soak on the card: the port of the JAX package's
``tools/determinism_soak.py``.

Every hand-written chunk kernel and the scan tier's captured chunk must give
bit-identical states across repeated same-seed runs. A missed barrier, a
race between CTAs or a float atomic shows up as run-to-run differences long
before it corrupts a verdict, and the plain versions on the CPU cannot show
one. Runs, each ``repeats`` times from the same state:

* B1 (resident chunk) on hard.cnf B=2048, 2000 steps, fixed and adaptive;
* B2 (large-formula chunk) on a planted n=900 instance B=512, 500 steps,
  fixed and adaptive;
* B3 and B4 (stoch chunks), hard.cnf B=2048 2000 steps and n=900 B=512 500
  steps, one seed;
* B10 (the single-step RHS) on hard.cnf B=4096, one pass;
* the scan chunk (``ops/scan_chunk.py``, a CUDA graph of 64 steps) through
  ``gather``, ``segment_sum`` and ``pallas`` on hard.cnf B=2048, adaptive,
  and a device-loop dispatch of 8 such chunks.

Usage, on a machine with a CUDA card (it raises without one):

    python -m odesat_tpu_torch.tools.determinism_soak [repeats]

Prints an ``OK`` or ``FAIL`` line a run and exits non-zero on any failure.
"""

from __future__ import annotations

import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_repeats(name, make_state, runner, repeats) -> bool:
    """``runner(make_state())`` ``repeats`` times; True when every output
    equals the first bit for bit (a NaN equal to a NaN)."""
    ref = None
    for r in range(repeats):
        out = runner(make_state())
        torch.cuda.synchronize()
        snap = [t.clone() for t in out]
        del out  # a held result would keep the scan chunk's buffers from the next repeat
        if ref is None:
            ref = snap
            continue
        for i, (a, b) in enumerate(zip(ref, snap)):
            if not torch.equal(a, b) and not (a.is_floating_point() and
                                              torch.equal(a.isnan(), b.isnan()) and
                                              torch.equal(a.nan_to_num(), b.nan_to_num())):
                print(f"FAIL {name}: output {i} differs at repeat {r}", flush=True)
                return False
    print(f"OK   {name}: {repeats} repeats bit-identical", flush=True)
    return True


def soak(repeats: int = 4, device="cuda") -> bool:
    """Every run of the module docstring; True when all are bit-identical."""
    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file
    from odesat_tpu_torch.models.ode import (
        formula_device,
        init_state,
        make_chunk_runner,
        make_multi_chunk_runner,
    )
    from odesat_tpu_torch.models.stoch import init_stoch_state
    from odesat_tpu_torch.ops import fused_chunk, rhs_kernel, stoch_chunk, stream_chunk
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.generate import random_ksat

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the determinism soak runs the CUDA kernels: it needs a CUDA device")
    hard = compile_formula(normalize_cnf_variables(
        parse_dimacs_file(os.path.join(HERE, "tests", "data", "hard.cnf")))[1])
    big = compile_formula(normalize_cnf_variables(
        random_ksat(900, 3870, k=3, seed=5, planted=True))[1], bucket=True, window_sort=True)

    def fresh(fa, B, ode):
        return lambda: init_state(fa, B, torch.Generator(device).manual_seed(7), ode, device)

    ok = True
    for mode, kw in (("fixed", dict(step_size=0.01)), ("adaptive", dict(tolerance=1e-3))):
        ode = ODEConfig(**kw)
        fn = fused_chunk.make_fused_chunk(hard, 0.001, ode, 2000, device)
        ok &= run_repeats(f"B1 fused/{mode} (hard.cnf B=2048, 2000 steps)",
                          fresh(hard, 2048, ode), fn, repeats)
        fn = stream_chunk.make_stream_chunk(big, 0.001, ode, 500, device)
        ok &= run_repeats(f"B2 stream/{mode} (n=900 B=512, 500 steps)",
                          fresh(big, 512, ode), fn, repeats)
    for kernel, fa, B, steps, label in (("fused", hard, 2048, 2000, "B3"),
                                        ("stream", big, 512, 500, "B4")):
        fn = stoch_chunk.make_stoch_chunk(fa, steps, kernel, "float32", device)
        ok &= run_repeats(f"{label} stoch-{kernel} ({B} chains, {steps} steps)",
                          lambda fa=fa, B=B: init_stoch_state(fa, B, device),
                          lambda st, fn=fn: fn(st, 12345), repeats)
    rhs = rhs_kernel.make_rhs_kernel(hard, 0.05, device=device)
    ok &= run_repeats("B10 rhs (hard.cnf B=4096, one pass)", fresh(hard, 4096, ODEConfig()),
                      lambda st: rhs(st.v, st.xs, st.xl), repeats)
    dev = formula_device(hard, device)
    for strategy in ("gather", "segment_sum", "pallas"):
        ode = ODEConfig(tolerance=1e-3, dv_strategy=strategy)
        chunk = make_chunk_runner(hard, 0.05, ode, 64, device)
        ok &= run_repeats(f"scan chunk {strategy}/adaptive (hard.cnf B=2048, 64 steps)",
                          fresh(hard, 2048, ode), lambda st, c=chunk: c(st, dev), repeats)
        multi = make_multi_chunk_runner(hard, 0.05, ode, 64, 8, device, chunk=chunk)
        ok &= run_repeats(f"device loop over the scan chunk {strategy} (8 chunks of 64)",
                          fresh(hard, 2048, ode), lambda st, m=multi: m(st, dev)[0], repeats)
    return ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    repeats = int(argv[0]) if argv else 4
    return 0 if soak(repeats) else 1


if __name__ == "__main__":
    sys.exit(main())
