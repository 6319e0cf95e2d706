#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (odesat_tpu_torch) runs on an
NVIDIA GPU: builds the CUDA chunk kernel from this checkout, holds it
against its plain torch version, and drives the port's main path
(``python -m odesat_tpu_torch inter``, in process) through it.

Run from the root of a checkout on a machine with one Hopper GPU and nvcc:

    python3 chip_smoke.py

Phases, each printing its lines; the first failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: nvcc of csrc/fused_chunk.cu, seconds and ptxas's resource lines;
3. kernel vs plain: random 3- and 4-SAT formulas, a formula of widths 2,
   3 and 5 (plain and width-bucketed), hard.cnf at B=16384, uf250 at
   B=4096 and an odd B=1000, both integrators, both rigidity gates,
   float32 and bf16 rounding, after one 32-step chunk; then uf250 at
   B=4096 from a partly solved state, until a compared chunk holds rows
   done before it, rows that finish inside it and rows still running
   (both integrators, float32 and bf16). Tolerances: float32 rtol 2e-4 /
   atol 2e-5 (tests/test_fused.py's), bf16 rtol 1e-2 / atol 1e-2; done
   exactly in both; rows done before a chunk come out unchanged;
4. determinism: the same input twice gives bit-identical outputs;
5. main path, SAT: inter on uf250 (seed 0) at -b 4096 -s 0.01 -n 20000
   --seed 0, and on easy.cnf adaptive at -b 256 -n 20000 --seed 1, must
   verify true, with the kernel launched;
6. main path, UNSAT budget: inter on hard.cnf at -b 16384 -s 0.01 -n 4096,
   float32 and bf16: verdict false after exactly 4096 steps, kernel
   launched; prints traj*steps/s;
7. timing: the kernel's and the plain version's device time per 256-step
   chunk at hard.cnf B=16384 and uf250 B=4096 (CUDA events).

The last two lines are one JSON object per kernel and then
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, ".scratch", "chip_smoke")  # git-ignored
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build(fc):
    t0 = time.perf_counter()
    _, build = fc.load_library()
    say(f"[build] csrc/fused_chunk.cu -> {os.path.relpath(build['path'], ROOT)} "
        f"nvcc {build['seconds']:.1f} s (cached={build['cached']}), "
        f"load {time.perf_counter() - t0:.1f} s")
    for line in build["log"].splitlines():
        if "registers" in line or "bytes stack frame" in line:
            say(f"[build] ptxas {line.strip()}")


def load_cases():
    from odesat_tpu_torch.cnf import (
        CNFFormula,
        compile_formula,
        normalize_cnf_variables,
        parse_dimacs_file,
    )
    from odesat_tpu_torch.utils.generate import random_ksat, uf_instance

    def fa_of(formula, bucket=False):
        return compile_formula(normalize_cnf_variables(formula)[1], window_sort=True,
                               bucket=bucket)

    # widths 2, 3 and 5: padding slots inside the (K, Mp) grid, and with
    # bucketing a clause axis sorted into three width buckets
    mixed = CNFFormula(
        [c for k in (2, 3, 5) for c in random_ksat(300, 400, k=k, seed=10 + k).clauses], 300
    )

    hard = fa_of(parse_dimacs_file(os.path.join(ROOT, "tests", "data", "hard.cnf")))
    uf250 = fa_of(uf_instance(250, seed=0))
    cases = [
        ("ksat n=50 m=213 seed=0", fa_of(random_ksat(50, 213, seed=0)), 257),
        ("ksat n=100 m=300 k=4 seed=1", fa_of(random_ksat(100, 300, k=4, seed=1)), 129),
        ("ksat n=200 m=852 seed=2 planted", fa_of(random_ksat(200, 852, seed=2, planted=True)), 64),
        ("widths 2,3,5 n=300 m=1200", fa_of(mixed), 300),
        ("widths 2,3,5 n=300 m=1200 bucketed", fa_of(mixed, bucket=True), 300),
        ("hard.cnf B=16384", hard, 16384),
        ("uf250 B=4096", uf250, 4096),
        ("hard.cnf B=1000", hard, 1000),
    ]
    return cases, hard, uf250


def random_state(fa, B, seed):
    """A fresh batch on the card: v ~ U(-1, 1) from ``seed`` (NumPy), xs
    from the all-false valuation, xl = 1, dt = 0.01, nothing done."""
    import numpy as np

    from odesat_tpu_torch.interop import state_from_numpy

    v = np.random.default_rng(seed).uniform(-1, 1, (B, fa.n_vars_padded)).astype(np.float32)
    xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
    return state_from_numpy(v, xs, np.ones_like(xs), np.full(B, 0.01, np.float32),
                            np.zeros(B, bool), device="cuda")


def compare(torch, out, ref, tol):
    """Max abs error over v/xs/xl/dt, after checking the tolerance and
    that done matches exactly; returns (error, None) or (None, why)."""
    worst = 0.0
    for name in ("v", "xs", "xl", "dt"):
        a, b = getattr(out, name), getattr(ref, name)
        if not torch.isfinite(a).all():
            return None, f"{name} not finite"
        if not torch.allclose(a, b, **tol):
            err = (a - b).abs().max().item()
            return None, f"{name} off by {err} (tolerance {tol})"
        worst = max(worst, (a - b).abs().max().item())
    if not torch.equal(out.done, ref.done):
        return None, f"done differs in {int((out.done != ref.done).sum())} rows"
    return worst, None


def phase_compare(torch, fc, cases):
    from odesat_tpu_torch.utils.config import ODEConfig

    worst = 0.0
    lib, _ = fc.load_library()
    for label, fa, B in cases:
        nnz = int((fa.lit_mask > 0).sum())
        K, Mp = fa.lit_var.shape
        for fixed in (True, False):
            c_bytes = lib.fused_chunk_smem_bytes(fa.n_vars_padded, Mp, K, nnz, int(fixed))
            if c_bytes != fc.fused_smem_bytes(fa, fixed):
                fail(f"{label}: shared-memory gate {fc.fused_smem_bytes(fa, fixed)} != "
                     f"kernel's {c_bytes}")
        state = random_state(fa, B, seed=B)
        for mode in ("fixed", "adaptive"):
            for rigidity in ("paper", "reference"):
                for mm in ("float32", "bfloat16"):
                    ode = ODEConfig(step_size=0.01 if mode == "fixed" else None,
                                    rigidity=rigidity, matmul_dtype=mm)
                    zeta = ode.resolve_zeta(fa.density)
                    fn = fc.make_fused_chunk(fa, zeta, ode, 32, "cuda")
                    out = fn(state)
                    ref = fc.fused_chunk_plain(state, fn.spec, 32)
                    torch.cuda.synchronize()
                    err, why = compare(torch, out, ref, F32_TOL if mm == "float32" else BF16_TOL)
                    tag = f"{label} {mode} {rigidity} {mm}"
                    if why:
                        fail(f"kernel vs plain, {tag}: {why}")
                    worst = max(worst, err)
                    say(f"[compare] {tag}: max abs err {err:.3e}, "
                        f"done {int(out.done.sum())}/{B}")
    return worst


def phase_compare_finishing(torch, fc, uf250):
    """Kernel vs plain on chunks in which trajectories finish. uf250
    (planted SAT) at B=4096 is advanced by the kernel until some rows are
    done; then 32-step chunks are compared one after another, each from
    the kernel's last output, until one holds rows done before it (the
    freeze), rows that finish inside it (the done latch, the fixed
    integrator's update-then-freeze, the adaptive no-advance branch) and
    rows still running. Rows done before a chunk must come out unchanged."""
    from odesat_tpu_torch.utils.config import ODEConfig

    B, worst = 4096, 0.0
    for mode in ("fixed", "adaptive"):
        for mm in ("float32", "bfloat16"):
            ode = ODEConfig(step_size=0.01 if mode == "fixed" else None, matmul_dtype=mm)
            zeta = ode.resolve_zeta(uf250.density)
            feed = fc.make_fused_chunk(uf250, zeta, ode, 64, "cuda")
            fn = fc.make_fused_chunk(uf250, zeta, ode, 32, "cuda")
            tag = f"uf250 B={B} {mode} {mm}"
            state, steps = random_state(uf250, B, seed=11), 0
            while not bool(state.done.any()):
                if steps >= 20000:
                    fail(f"finishing, {tag}: no trajectory solved in {steps} steps")
                state, steps = feed(state), steps + 64
            for _ in range(64):
                out = fn(state)
                ref = fc.fused_chunk_plain(state, fn.spec, 32)
                torch.cuda.synchronize()
                err, why = compare(torch, out, ref, F32_TOL if mm == "float32" else BF16_TOL)
                if why:
                    fail(f"kernel vs plain, {tag} from step {steps}: {why}")
                worst = max(worst, err)
                was = state.done
                for name in ("v", "xs", "xl", "dt"):
                    if not torch.equal(getattr(out, name)[was], getattr(state, name)[was]):
                        fail(f"finishing, {tag}: the kernel moved {name} of a done row")
                before, after = int(was.sum()), int(out.done.sum())
                state, steps = out, steps + 32
                if 0 < before < after < B:
                    say(f"[compare] {tag}, chunk ending at step {steps}: done {before} -> "
                        f"{after}/{B}, max abs err {err:.3e}")
                    break
            else:
                fail(f"finishing, {tag}: no trajectory finished inside a compared chunk "
                     f"by step {steps}")
    return worst


def phase_determinism(torch, fc, hard, uf250):
    from odesat_tpu_torch.utils.config import ODEConfig

    for label, fa, B, ode in (
        ("hard.cnf B=16384 fixed f32", hard, 16384, ODEConfig(step_size=0.01)),
        ("uf250 B=4096 adaptive f32", uf250, 4096, ODEConfig()),
        ("uf250 B=4096 fixed bf16", uf250, 4096,
         ODEConfig(step_size=0.01, matmul_dtype="bfloat16")),
    ):
        state = random_state(fa, B, seed=7)
        fn = fc.make_fused_chunk(fa, ode.resolve_zeta(fa.density), ode, 256, "cuda")
        a, b = fn(state), fn(state)
        torch.cuda.synchronize()
        for x, y, name in zip(a, b, a._fields):
            if not torch.equal(x, y):
                fail(f"determinism, {label}: {name} differs between two identical launches")
        say(f"[determinism] {label}: two launches bit-identical")


def run_inter(fc, args):
    """The port's CLI in process, its kernel launch count reset first;
    returns (verdict, launches, steps, solved, seconds)."""
    from odesat_tpu_torch import cli

    fc.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["inter", *args])
    launches = fc.launches
    out = buf.getvalue()
    if rc != 0:
        fail(f"inter {' '.join(args)} exited {rc}:\n{out}")
    m = re.search(r"Steps run: (\d+) \| trajectories solved: (\d+)/(\d+) \| ([0-9.]+) s", out)
    if m is None:
        fail(f"inter printed no steps line:\n{out}")
    steps, solved, seconds = int(m.group(1)), int(m.group(2)), float(m.group(4))
    verdict = re.search(r"Checking if solution vector satisfies formula: (true|false)", out)
    if verdict is None:
        fail(f"inter printed no verdict:\n{out}")
    return verdict.group(1), launches, steps, solved, seconds


def phase_main_sat(fc):
    from odesat_tpu_torch.cnf import cnf_to_dimacs
    from odesat_tpu_torch.utils.generate import uf_instance

    os.makedirs(OUT, exist_ok=True)
    uf_path = os.path.join(OUT, "uf250_seed0.cnf")
    with open(uf_path, "w", encoding="utf-8") as fh:
        fh.write(cnf_to_dimacs(uf_instance(250, seed=0)))
    total = 0
    for label, args in (
        ("uf250 B=4096 fixed", ["-f", uf_path, "-b", "4096", "-s", "0.01", "-n", "20000",
                                "--seed", "0"]),
        ("easy.cnf B=256 adaptive", ["-f", os.path.join(ROOT, "tests", "data", "easy.cnf"),
                                     "-b", "256", "-n", "20000", "--seed", "1"]),
    ):
        verdict, launches, steps, solved, seconds = run_inter(fc, args)
        say(f"[main SAT] {label}: verdict {verdict}, {solved} solved after {steps} steps "
            f"in {seconds:.6f} s, kernel launches {launches}")
        if verdict != "true":
            fail(f"{label}: the port did not verify a satisfying assignment")
        if launches == 0:
            fail(f"{label}: the main path never launched the kernel")
        total += launches
    return total


def phase_main_unsat(fc, card):
    total = 0
    hard = os.path.join(ROOT, "tests", "data", "hard.cnf")
    for mm in ("float32", "bfloat16"):
        args = ["-f", hard, "-b", "16384", "-s", "0.01", "-n", "4096", "--seed", "0",
                "--matmul-dtype", mm]
        verdict, launches, steps, solved, seconds = run_inter(fc, args)
        rate = 16384 * steps / seconds
        say(f"[main UNSAT] hard.cnf B=16384 {mm}: verdict {verdict} after {steps} steps in "
            f"{seconds:.6f} s = {rate:.6e} traj*steps/s, kernel launches {launches} "
            f"({card})")
        if verdict != "false" or steps != 4096 or solved != 0:
            fail(f"hard.cnf {mm}: expected false after exactly 4096 steps")
        if launches == 0:
            fail(f"hard.cnf {mm}: the main path never launched the kernel")
        total += launches
    return total


def phase_timing(torch, fc, hard, uf250, card):
    """Kernel and plain version in turns (plain, kernel, kernel, plain) on
    the same input; each time is the mean of its two turns."""
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.timing import cuda_ms

    times = {}
    for label, fa, B in (("hard.cnf B=16384", hard, 16384), ("uf250 B=4096", uf250, 4096)):
        for mode in ("fixed", "adaptive"):
            ode = ODEConfig(step_size=0.01 if mode == "fixed" else None)
            state = random_state(fa, B, seed=3)
            fn = fc.make_fused_chunk(fa, ode.resolve_zeta(fa.density), ode, 256, "cuda")

            def plain_turn():
                return cuda_ms(lambda: fc.fused_chunk_plain(state, fn.spec, 256), 2, warmup=1)

            def kernel_turn():
                return cuda_ms(lambda: fn(state), iters=10, warmup=2)

            p1, k1, k2, p2 = plain_turn(), kernel_turn(), kernel_turn(), plain_turn()
            kernel, plain = (k1 + k2) / 2, (p1 + p2) / 2
            times[(label, mode)] = (kernel, plain)
            say(f"[timing] {label} {mode} f32, 256-step chunk: kernel {k1:.6f} / {k2:.6f} ms, "
                f"plain {p1:.6f} / {p2:.6f} ms ({plain / kernel:.3f}x), "
                f"kernel {B * 256 / kernel * 1e3:.6e} traj*steps/s ({card})")
    return times


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import odesat_tpu_torch
    from odesat_tpu_torch.ops import fused_chunk as fc

    if not os.path.abspath(odesat_tpu_torch.__file__).startswith(ROOT + os.sep):
        fail(f"odesat_tpu_torch came from {odesat_tpu_torch.__file__}, not this checkout")
    if "jax" in sys.modules:
        fail("jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    card = phase_device(torch)
    phase_build(fc)
    cases, hard, uf250 = load_cases()
    worst = phase_compare(torch, fc, cases)
    worst = max(worst, phase_compare_finishing(torch, fc, uf250))
    say(f"[compare] all cases within tolerance; max abs err {worst:.6e}")
    phase_determinism(torch, fc, hard, uf250)
    launches = phase_main_sat(fc)
    launches += phase_main_unsat(fc, card)
    times = phase_timing(torch, fc, hard, uf250, card)
    if "jax" in sys.modules:
        fail("jax was imported")
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    kernel_ms, plain_ms = times[("hard.cnf B=16384", "fixed")]
    say(json.dumps({"kernels": [{
        "name": "fused_chunk",
        "route": "cuda",
        "source": "odesat_tpu_torch/csrc/fused_chunk.cu",
        "replaces": "odesat_tpu/ops/fused_pallas.py:66",
        "launches": launches,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
