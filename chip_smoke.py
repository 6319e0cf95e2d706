#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (odesat_tpu_torch) runs on an
NVIDIA GPU: builds the CUDA kernels from this checkout, holds each against
its plain torch version, and drives the port's main paths (``python -m
odesat_tpu_torch inter``, ``stoch``, ``solve`` and ``batch``, in process)
through them.

Run from the root of a checkout on a machine with one Hopper GPU and nvcc:

    python3 chip_smoke.py

Phases, each printing its lines; the first failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: nvcc of csrc/fused_chunk.cu, csrc/stoch_chunk.cu (B3, B4, B8, B9)
   and csrc/stream_chunk.cu (B2, B5, B6, B10) and g++ of the native preprocessor
   (csrc/odesat_native.cc), all started together; seconds, ptxas's
   registers and spills, and whether the preprocessor runs native;
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
   chunk at hard.cnf B=16384 and uf250 B=4096 (CUDA events);
8. stoch kernel vs plain: B3 (resident) and B4 (tables in L2) on the
   formulas of phase 3, and B4 on the preprocessed n=1k
   instance (run_benchmarks.py config 4) at B=8192, f32 and bf16, random
   v and xl up to 3000; then a planted 3-SAT (n=200, m=700) at B=4096
   until a compared chunk holds chains done before it, chains that
   finish in it and chains still running. Exact equality of v, xl and
   done; B3 and B4 equal on every formula both take;
9. stoch determinism: two launches give bit-identical outputs;
10. stoch main path: stoch on easy.cnf at -b 4096 verifies true through
    B3; stoch --no-preprocess on hard.cnf at -b 16384 -n 4096 (f32 and
    bf16) gives false after exactly 4096 steps; stoch on the n=1k
    instance at -b 8192 runs B4 (a solved chain must verify); stoch on a
    planted 5-SAT (n=2000, m=8000, past B3's gate) verifies true
    through B4; each prints chain*steps/s;
11. stoch timing: kernel and plain version in turns over the same steps,
    B3 and B4 at hard.cnf B=16384, B4 at the n=1k instance B=8192;
12. B2 vs plain: the large-formula chunk kernel against its plain version
    (B1's), exactly (max abs error 0, done equal), on phase 3's formulas
    (where it must also equal B1) and on the formulas past B1's gate at
    their main-path batches: the preprocessed n=1k instance at B=10240,
    the preprocessed planted n=2000 m=7000 at B=1024 and the locally
    structured n=4096 (config 6) at B=10240; both integrators, both
    rigidity gates, f32 and bf16, one chunk; then phase 3's finishing
    chunks on uf250 through B2; then two launches bit-identical;
13. B2 main path: solve on the planted n=2000 m=7000 (adaptive and fixed)
    and batch on the planted n=2000 m=8000 at -b 1024 verify true; solve
    on the n=1k instance at --solve-batch 10240 (f32, bf16) and inter on
    the n=4096 instance at -b 10240 (a solved trajectory must verify);
    inter --dv-strategy stream on hard.cnf at -b 16384 ends false after
    exactly 4096 steps; each through B2, each printing traj*steps/s;
14. B2 timing: B2 and plain per chunk in turns at the n=1k instance
    B=10240 (fixed, adaptive), the n=4096 instance B=10240 and hard.cnf
    B=16384 (beside B1);
15. B10 vs the twin's gather RHS at hard.cnf B=16384, uf250 B=4096 and the
    n=1k instance B=1024, f32 (rtol 2e-4 / atol 2e-5) and f64 (1e-12);
16. B10 main path: inter --dv-strategy pallas on hard.cnf at -b 4096 ends
    false after exactly 1024 steps, on uf250 true;
17. B10 timing: one RHS pass, B10 and the twin in turns, hard.cnf B=16384;
18. B5 vs plain, exactly (max abs error 0): phase 3's formulas compiled
    with compile_stream_sharded at S=1 and S=2 (each shard on its own) and
    the config 7 instance (run_benchmarks.py:289-313, n=10240) at S=2 (both
    shards) and S=1, B=1024; modes rhs, fixed, second, both rigidity gates,
    f32 and bf16; then two launches bit-identical; then B6 (the
    clause-sharded chunk's launches) the same way, in each of its phases
    with and without the apply prologue;
19. B8 vs plain, exactly, on the same shards, random xl up to 3000 and
    frozen chains, f32 and bf16; then two launches bit-identical; then B9
    (the stoch chunk's launches) with and without the flip prologue and
    flip-only;
20. the clause mesh through the CLI, two gloo ranks sharing the card
    (spawned; each reports its launch counts; every solve checks that its
    clause ranks' v are bit-identical and raises otherwise): a. inter on
    uf250 -b 4096 --clause-shards 2 verifies true through B6; b. inter on
    the config 7 instance -b 1024 -n 256 ends false after exactly 256 steps
    (or verifies), through B6 and with --shard-chunk off through B5, on
    both ranks; the ODE clause mesh at S=2 on the config 7 instance (B6 and
    B5, fixed 8 steps and adaptive 4) against the in-process S=1 runner row
    for row (rtol 2e-4 / atol 2e-5, xs and xl clause by clause, done
    exactly), B6 equal to B5 bit for bit and both ranks' v bit-identical;
    c. stoch --no-preprocess on the config 7 instance for 128 steps through
    B9 and with --shard-chunk off through B8, the clause path at S=2 equal
    to S=1 flip for flip through each, and stoch on easy.cnf verifying true
    through B9; d. the clause step and the B6 chunk over an NCCL world of
    one equal the mesh-free B5 runner bit for bit; e. inter --devices 2 on
    uf250 B=4096 through B1 equals the T=1 run row for row;
21. timing at the config 7 instance, B=1024, S=1: B5 fixed and second, B6
    step, B8 and B9 per launch beside their plain versions and bounds, the
    single-device runner (B5) and the B6 chunk in traj*steps/s, and the
    gloo all-reduce per step at S=2 (staged through the host).

The last two lines are the ``kernels`` JSON object (one row per kernel,
with its bound: the larger of its bytes over 3.35 TB/s and its operations
over 67 TFLOP/s) and then ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the package beside this script, it exits non-zero
and prints no result.
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


def phase_build(fc, sc, stc):
    """Build the three CUDA sources and the native host library at once
    (one nvcc per source, all started together), then report each."""
    from concurrent.futures import ThreadPoolExecutor

    from odesat_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        jobs = {name: pool.submit(fn) for name, fn in (
            ("fused_chunk", fc.load_library), ("stoch_chunk", sc.load_library),
            ("stream_chunk", stc.load_library), ("native", native.build_info))}
        results = {name: job.result() for name, job in jobs.items()}
    for name in ("fused_chunk", "stoch_chunk", "stream_chunk"):
        _, build = results[name]
        say(f"[build] csrc/{name}.cu -> {os.path.relpath(build['path'], ROOT)} "
            f"nvcc {build['seconds']:.1f} s (cached={build['cached']})")
        for line in build["log"].splitlines():
            if "registers" in line or "bytes stack frame" in line:
                say(f"[build] {name} ptxas {line.strip()}")
    info = results["native"]
    if info["available"]:
        say(f"[build] native preprocessor {os.path.relpath(info['path'], ROOT)} g++ "
            f"{info['seconds']:.1f} s (cached={info['cached']}); the preprocessor runs native")
    else:
        say(f"[build] native preprocessor unavailable ({info['error']}); "
            "the preprocessor runs in Python")
    say(f"[build] all builds {time.perf_counter() - t0:.1f} s")


def load_cases():
    """Phase 3's formulas: ``(cases, hard, uf250, specs)`` where ``cases``
    holds (label, FormulaArrays, B) and ``specs`` (label, normalized
    formula, bucket, B), from which the clause-shard phases recompile."""
    from odesat_tpu_torch.cnf import (
        CNFFormula,
        compile_formula,
        normalize_cnf_variables,
        parse_dimacs_file,
    )
    from odesat_tpu_torch.utils.generate import random_ksat, uf_instance

    def norm(formula):
        return normalize_cnf_variables(formula)[1]

    # widths 2, 3 and 5: padding slots inside the (K, Mp) grid, and with
    # bucketing a clause axis sorted into three width buckets
    mixed = norm(CNFFormula(
        [c for k in (2, 3, 5) for c in random_ksat(300, 400, k=k, seed=10 + k).clauses], 300))
    hard = norm(parse_dimacs_file(os.path.join(ROOT, "tests", "data", "hard.cnf")))
    uf250 = norm(uf_instance(250, seed=0))
    specs = [
        ("ksat n=50 m=213 seed=0", norm(random_ksat(50, 213, seed=0)), False, 257),
        ("ksat n=100 m=300 k=4 seed=1", norm(random_ksat(100, 300, k=4, seed=1)), False, 129),
        ("ksat n=200 m=852 seed=2 planted", norm(random_ksat(200, 852, seed=2, planted=True)),
         False, 64),
        ("widths 2,3,5 n=300 m=1200", mixed, False, 300),
        ("widths 2,3,5 n=300 m=1200 bucketed", mixed, True, 300),
        ("hard.cnf B=16384", hard, False, 16384),
        ("uf250 B=4096", uf250, False, 4096),
        ("hard.cnf B=1000", hard, False, 1000),
    ]
    cases = [(label, compile_formula(f, window_sort=True, bucket=bucket), B)
             for label, f, bucket, B in specs]
    return cases, cases[5][1], cases[6][1], specs


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


def phase_compare_finishing(torch, fc, uf250, make=None, tol=None, kernel="B1"):
    """Kernel vs plain on chunks in which trajectories finish. uf250
    (planted SAT) at B=4096 is advanced by the kernel until some rows are
    done; then 32-step chunks are compared one after another, each from
    the kernel's last output, until one holds rows done before it (the
    freeze), rows that finish inside it (the done latch, the fixed
    integrator's update-then-freeze, the adaptive no-advance branch) and
    rows still running. Rows done before a chunk must come out unchanged.
    ``make`` builds the chunk (B1's by default; B2's plain version is B1's);
    ``tol`` overrides the tolerance (B2 is held to exact equality)."""
    from odesat_tpu_torch.utils.config import ODEConfig

    make = make or fc.make_fused_chunk
    B, worst = 4096, 0.0
    for mode in ("fixed", "adaptive"):
        for mm in ("float32", "bfloat16"):
            ode = ODEConfig(step_size=0.01 if mode == "fixed" else None, matmul_dtype=mm)
            zeta = ode.resolve_zeta(uf250.density)
            feed = make(uf250, zeta, ode, 64, "cuda")
            fn = make(uf250, zeta, ode, 32, "cuda")
            tag = f"{kernel} uf250 B={B} {mode} {mm}"
            state, steps = random_state(uf250, B, seed=11), 0
            while not bool(state.done.any()):
                if steps >= 20000:
                    fail(f"finishing, {tag}: no trajectory solved in {steps} steps")
                state, steps = feed(state), steps + 64
            for _ in range(64):
                out = fn(state)
                ref = fc.fused_chunk_plain(state, fn.spec, 32)
                torch.cuda.synchronize()
                err, why = compare(torch, out, ref,
                                   tol or (F32_TOL if mm == "float32" else BF16_TOL))
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


def run_cli(counters, cmd, args):
    """The port's CLI in process, every kernel launch count set to 0 just
    before and read just after. ``counters`` maps a kernel name to its
    (module, attribute). Returns (verdict, launches by kernel, steps,
    solved, seconds, output)."""
    from odesat_tpu_torch import cli

    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([cmd, *args])
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    out = buf.getvalue()
    if rc != 0:
        fail(f"{cmd} {' '.join(args)} exited {rc}:\n{out}")
    m = re.search(r"Steps run: (\d+) \| (?:trajectories|chains) solved: (\d+)/(\d+) \| "
                  r"([0-9.]+) s", out)
    if m is None:
        fail(f"{cmd} printed no steps line:\n{out}")
    steps, solved, seconds = int(m.group(1)), int(m.group(2)), float(m.group(4))
    verdict = re.search(r"Checking if solution vector satisfies formula: (true|false)", out)
    if verdict is None:
        fail(f"{cmd} printed no verdict:\n{out}")
    return verdict.group(1), launches, steps, solved, seconds, out


def run_inter(fc, args):
    """``inter`` through :func:`run_cli`; returns (verdict, launches,
    steps, solved, seconds)."""
    verdict, launches, steps, solved, seconds, _ = run_cli(
        {"fused_chunk": (fc, "launches")}, "inter", args)
    return verdict, launches["fused_chunk"], steps, solved, seconds


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


# ------------------------------------------------------------ stoch (B3, B4)

STOCH_KERNELS = ("fused", "stream")


def stoch_counters(fc, sc):
    return {"fused_chunk": (fc, "launches"), "stoch_fused": (sc, "fused_launches"),
            "stoch_stream": (sc, "stream_launches")}


def n1k_instance():
    """run_benchmarks.py config 4: planted random 3-SAT n=1000 m=4300."""
    from odesat_tpu_torch.utils.generate import random_ksat

    return random_ksat(1000, 4300, k=3, seed=7, planted=True)


def sat5_instance():
    """A SAT instance past B3's gate that B4 solves: planted random 5-SAT,
    n=2000, m=8000 (ratio 4), seed 11. Preprocessed it has 1892 variables
    and 13,239 clauses of widths up to 8, about 1.3 MB of B3 tables.
    (The engine's parallel flips stall on this family from ratio 6 on.)"""
    from odesat_tpu_torch.utils.generate import random_ksat

    return random_ksat(2000, 8000, k=5, seed=11, planted=True)


def preprocessed_n1k():
    from odesat_tpu_torch.preprocess import preprocess_formula

    t0 = time.perf_counter()
    reduced, _ = preprocess_formula(n1k_instance(), 7.0)
    say(f"[n1k] n=1k instance preprocessed in {time.perf_counter() - t0:.3f} s: "
        f"{reduced.num_clauses} clauses, {reduced.varnum} vars")
    return reduced


def load_stoch_cases(cases, reduced):
    """The ODE phase's formulas, then the preprocessed n=1k instance
    (K=9, Mp=6528: past B3's gate) at B=8192, the main path's shapes."""
    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables

    n1k = compile_formula(normalize_cnf_variables(reduced)[1], bucket=True)
    stoch_cases = [*cases, ("n1k preprocessed B=8192", n1k, 8192)]
    return stoch_cases, n1k


def stoch_state(fa, B, seed, xl_hi=3000):
    """Chains on the card: v random bits, xl random in [1, xl_hi] (past
    256, so bf16 rounds), nothing done; from NumPy."""
    import numpy as np

    from odesat_tpu_torch.interop import stoch_state_from_numpy

    rng = np.random.default_rng(seed)
    v = rng.random((B, fa.n_vars_padded)) < 0.5
    xl = rng.integers(1, xl_hi + 1, (B, fa.n_clauses_padded)).astype(np.int32)
    return stoch_state_from_numpy(v, xl, np.zeros(B, bool), device="cuda")


def stoch_compare(torch, out, ref):
    """Exact equality of v, xl and done; returns (max abs error, why)."""
    worst = 0
    for name in ("v", "xl", "done"):
        a, b = getattr(out, name), getattr(ref, name)
        if not torch.equal(a, b):
            return None, f"{name} differs in {int((a != b).sum())} entries"
        worst = max(worst, int((a.long() - b.long()).abs().max()) if a.numel() else 0)
    return float(worst), None


def stoch_kernels_for(sc, fa):
    return [k for k in STOCH_KERNELS if k == "stream" or sc.stoch_fused_supported(fa)]


def phase_stoch_compare(torch, sc, stoch_cases):
    from odesat_tpu_torch.ops.stoch_chunk import make_stoch_chunk, stoch_chunk_plain, traj_block

    lib, _ = sc.load_library()
    worst = dict.fromkeys(STOCH_KERNELS, 0.0)
    for label, fa, B in stoch_cases:
        nnz = int((fa.lit_mask > 0).sum())
        K, Mp = fa.lit_var.shape
        Np = fa.n_vars_padded
        if lib.stoch_fused_smem_bytes(Np, Mp, K, nnz) != sc.stoch_fused_smem_bytes(fa) or \
                lib.stoch_stream_smem_bytes(Np, Mp) != sc.stoch_stream_smem_bytes(fa):
            fail(f"{label}: a stoch shared-memory gate differs from the kernel's")
        steps = 8 if B * Mp > 2**24 else 32
        state = stoch_state(fa, B, seed=B)
        outs = {}
        for kernel in stoch_kernels_for(sc, fa):
            for mm in ("float32", "bfloat16"):
                fn = make_stoch_chunk(fa, steps, kernel, mm, "cuda")
                out = fn(state, 1234567)
                ref = stoch_chunk_plain(state, fn.spec, steps, 1234567, traj_block(B),
                                        mm == "bfloat16")
                torch.cuda.synchronize()
                err, why = stoch_compare(torch, out, ref)
                tag = f"{label} {kernel} {mm} {steps} steps"
                if why:
                    fail(f"stoch kernel vs plain, {tag}: {why}")
                worst[kernel] = max(worst[kernel], err)
                outs[(kernel, mm)] = out
                say(f"[stoch compare] {tag}: equal (max abs err {err:.1f}), "
                    f"flips {int((out.v != state.v).sum())}, done {int(out.done.sum())}/{B}")
        for mm in ("float32", "bfloat16"):
            if ("fused", mm) in outs:
                _, why = stoch_compare(torch, outs[("fused", mm)], outs[("stream", mm)])
                if why:
                    fail(f"B3 vs B4, {label} {mm}: {why}")
                say(f"[stoch B3 vs B4] {label} {mm}: equal")
    return worst


def phase_stoch_finishing(torch, sc, planted):
    """Kernel vs plain on chunks in which chains finish: from the all-false
    start the kernel advances a planted formula until some chains are
    done; then 8-step chunks are compared, each from the kernel's last
    output, until one holds chains done before it, chains that finish in
    it and chains still running. Done chains must come out unchanged."""
    from odesat_tpu_torch.models.stoch import init_stoch_state
    from odesat_tpu_torch.ops.stoch_chunk import make_stoch_chunk, stoch_chunk_plain, traj_block

    B, worst = 4096, dict.fromkeys(STOCH_KERNELS, 0.0)
    for kernel in STOCH_KERNELS:
        for mm in ("float32", "bfloat16"):
            feed = make_stoch_chunk(planted, 32, kernel, mm, "cuda")
            fn = make_stoch_chunk(planted, 8, kernel, mm, "cuda")
            tag = f"planted 3-SAT n=200 m=700 B={B} {kernel} {mm}"
            state, steps, seed = init_stoch_state(planted, B, "cuda"), 0, 1
            while not bool(state.done.any()):
                if steps >= 20000:
                    fail(f"stoch finishing, {tag}: no chain solved in {steps} steps")
                state, steps, seed = feed(state, seed), steps + 32, seed + 1
            for _ in range(256):
                out = fn(state, seed)
                ref = stoch_chunk_plain(state, fn.spec, 8, seed, traj_block(B), mm == "bfloat16")
                torch.cuda.synchronize()
                err, why = stoch_compare(torch, out, ref)
                if why:
                    fail(f"stoch kernel vs plain, {tag} from step {steps}: {why}")
                worst[kernel] = max(worst[kernel], err)
                was = state.done
                for name in ("v", "xl"):
                    if not torch.equal(getattr(out, name)[was], getattr(state, name)[was]):
                        fail(f"stoch finishing, {tag}: the kernel moved {name} of a done chain")
                before, after = int(was.sum()), int(out.done.sum())
                state, steps, seed = out, steps + 8, seed + 1
                if 0 < before < after < B:
                    say(f"[stoch compare] {tag}, chunk ending at step {steps}: done {before} -> "
                        f"{after}/{B}, equal (max abs err {err:.1f})")
                    break
            else:
                fail(f"stoch finishing, {tag}: no chain finished inside a compared chunk "
                     f"by step {steps}")
    return worst


def phase_stoch_determinism(torch, sc, hard, n1k):
    from odesat_tpu_torch.ops.stoch_chunk import make_stoch_chunk

    for label, fa, B, kernel, steps in (("hard.cnf B=16384", hard, 16384, "fused", 256),
                                        ("hard.cnf B=16384", hard, 16384, "stream", 256),
                                        ("n1k B=8192", n1k, 8192, "stream", 32)):
        state = stoch_state(fa, B, seed=7)
        fn = make_stoch_chunk(fa, steps, kernel, "float32", "cuda")
        a, b = fn(state, 99), fn(state, 99)
        torch.cuda.synchronize()
        for x, y, name in zip(a, b, a._fields):
            if not torch.equal(x, y):
                fail(f"stoch determinism, {label} {kernel}: {name} differs between two launches")
        say(f"[stoch determinism] {label} {kernel}: two launches bit-identical")


def phase_stoch_main(fc, sc, card):
    """The stoch main path through the CLI; returns launches by kernel."""
    from odesat_tpu_torch.cnf import cnf_to_dimacs

    os.makedirs(OUT, exist_ok=True)
    n1k_path = os.path.join(OUT, "ksat_n1000_m4300_seed7_planted.cnf")
    sat5_path = os.path.join(OUT, "ksat5_n2000_m8000_seed11_planted.cnf")
    for path, formula in ((n1k_path, n1k_instance()), (sat5_path, sat5_instance())):
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(cnf_to_dimacs(formula))
    counters = stoch_counters(fc, sc)
    total = {name: 0 for name in counters}
    hard = os.path.join(ROOT, "tests", "data", "hard.cnf")
    easy = os.path.join(ROOT, "tests", "data", "easy.cnf")
    runs = (
        # label, args, kernel that must run, expected verdict (None: any)
        ("easy.cnf B=4096", ["-f", easy, "-b", "4096", "-n", "20000", "--seed", "1"],
         "stoch_fused", "true"),
        ("hard.cnf B=16384 f32 --no-preprocess", ["-f", hard, "--no-preprocess", "-b", "16384",
                                                  "-n", "4096", "--seed", "0"],
         "stoch_fused", "false"),
        ("hard.cnf B=16384 bf16 --no-preprocess", ["-f", hard, "--no-preprocess", "-b", "16384",
                                                   "-n", "4096", "--seed", "0",
                                                   "--matmul-dtype", "bfloat16"],
         "stoch_fused", "false"),
        ("n1k preprocessed B=8192", ["-f", n1k_path, "-b", "8192", "-n", "4096", "--seed", "0"],
         "stoch_stream", None),
        ("5-SAT n=2000 m=8000 B=1024", ["-f", sat5_path, "-b", "1024", "-n", "20000",
                                         "--seed", "0"],
         "stoch_stream", "true"),
    )
    for label, args, kernel, want in runs:
        verdict, launches, steps, solved, seconds, out = run_cli(counters, "stoch", args)
        B = int(args[args.index("-b") + 1])
        shape = re.search(r"Clauses: (\d+) \| Vars: (\d+)", out)
        shape = f", preprocessed to {shape.group(1)} clauses / {shape.group(2)} vars" \
            if shape else ""
        say(f"[stoch main] {label}{shape}: verdict {verdict}, {solved} solved after {steps} "
            f"steps in {seconds:.6f} s = {B * steps / seconds:.6e} chain*steps/s, launches "
            f"{launches} ({card})")
        if launches[kernel] == 0:
            fail(f"stoch {label}: the main path never launched {kernel}")
        if want == "false" and (verdict != "false" or steps != 4096 or solved != 0):
            fail(f"stoch {label}: expected false after exactly 4096 steps")
        if want == "true" and verdict != "true":
            fail(f"stoch {label}: the port did not verify a satisfying assignment")
        if solved and verdict != "true":
            fail(f"stoch {label}: a chain solved but its assignment did not verify")
        for name in total:
            total[name] += launches[name]
    return total


def phase_stoch_timing(torch, sc, hard, n1k, card):
    """Kernel and plain version in turns (plain, kernel, kernel, plain) on
    the same input and the same number of steps; each time is the mean of
    its two turns."""
    from odesat_tpu_torch.ops.stoch_chunk import make_stoch_chunk, stoch_chunk_plain, traj_block
    from odesat_tpu_torch.utils.timing import cuda_ms

    times = {}
    for label, fa, B, kernel, steps in (("hard.cnf B=16384", hard, 16384, "fused", 64),
                                        ("hard.cnf B=16384", hard, 16384, "stream", 64),
                                        ("n1k B=8192", n1k, 8192, "stream", 8)):
        state = stoch_state(fa, B, seed=3, xl_hi=1)
        fn = make_stoch_chunk(fa, steps, kernel, "float32", "cuda")
        Bb = traj_block(B)

        def plain_turn():
            return cuda_ms(lambda: stoch_chunk_plain(state, fn.spec, steps, 5, Bb, False), 2,
                           warmup=1)

        def kernel_turn():
            return cuda_ms(lambda: fn(state, 5), iters=10, warmup=2)

        p1, k1, k2, p2 = plain_turn(), kernel_turn(), kernel_turn(), plain_turn()
        kern, plain = (k1 + k2) / 2, (p1 + p2) / 2
        times[(label, kernel)] = (kern, plain)
        say(f"[stoch timing] {label} {kernel} f32, {steps}-step chunk: kernel {k1:.6f} / "
            f"{k2:.6f} ms, plain {p1:.6f} / {p2:.6f} ms ({plain / kern:.3f}x), kernel "
            f"{B * steps / kern * 1e3:.6e} chain*steps/s ({card})")
    return times


# ---------------------------------------------- large formulas (B2) and B10

EXACT = dict(rtol=0.0, atol=0.0)  # B2 computes exactly what its plain version (B1's) does


def planted_n2000(m):
    """Planted random 3-SAT, n=2000, seed 11: m=7000 preprocesses (ratio 7)
    to 1,523 variables and 10,631 clauses (K=11, Mp=11136, Np=1536);
    m=8000 unpreprocessed is K=3, Mp=8064, Np=2048. Both are past B1's
    gate in both integrators."""
    from odesat_tpu_torch.utils.generate import random_ksat

    return random_ksat(2000, m, k=3, seed=11, planted=True)


def local_n4096():
    """run_benchmarks.py config 6: locally structured 3-SAT, n=4096,
    m=17203, locality 256, seed 3 (window-sorted: K=3, Mp=17280)."""
    from odesat_tpu_torch.utils.generate import random_local_ksat

    return random_local_ksat(4096, 17203, k=3, locality=256, seed=3)


def load_stream_cases(n1k_reduced):
    """The real-size formulas past B1's gate, laid out as ``solve`` and
    ``inter`` lay them out (compile_for_config: width buckets on mixed
    widths, window-sorted), with the batch each is compared at."""
    from odesat_tpu_torch.cnf import normalize_cnf_variables
    from odesat_tpu_torch.models.ode import compile_for_config
    from odesat_tpu_torch.preprocess import preprocess_formula
    from odesat_tpu_torch.utils.config import SolverConfig

    def fa_of(formula):
        return compile_for_config(normalize_cnf_variables(formula)[1], SolverConfig())

    p2k, _ = preprocess_formula(planted_n2000(7000), 7.0)
    return [
        ("n1k preprocessed B=10240", fa_of(n1k_reduced), 10240, 8),
        ("planted n=2000 m=7000 preprocessed B=1024", fa_of(p2k), 1024, 16),
        ("local n=4096 B=10240", fa_of(local_n4096()), 10240, 8),
    ]


def phase_stream_compare(torch, fc, stc, cases, big):
    """B2 vs its plain version (B1's fused_chunk_plain), exactly, on phase
    3's formulas (each also vs B1, which takes them all) and on the
    real-size formulas past B1's gate: both integrators, both rigidity
    gates, f32 and bf16 rounding, one chunk."""
    from odesat_tpu_torch.utils.config import ODEConfig

    worst = 0.0
    for label, fa, B, steps in [*((lb, f, b, 32) for lb, f, b in cases), *big]:
        state = random_state(fa, B, seed=B + 1)
        for fixed in (True, False):
            lay = stc.stream_layout(fa.n_vars_padded, fa.n_clauses_padded, fixed)
            for rigidity in ("paper", "reference"):
                for mm in ("float32", "bfloat16"):
                    ode = ODEConfig(step_size=0.01 if fixed else None, rigidity=rigidity,
                                    matmul_dtype=mm)
                    zeta = ode.resolve_zeta(fa.density)
                    fn = stc.make_stream_chunk(fa, zeta, ode, steps, "cuda")
                    out = fn(state)
                    ref = stc.stream_chunk_plain(state, fn.spec, steps)
                    torch.cuda.synchronize()
                    tag = f"{label} {'fixed' if fixed else 'adaptive'} {rigidity} {mm}"
                    err, why = compare(torch, out, ref, EXACT)
                    if why:
                        fail(f"B2 vs plain, {tag}: {why}")
                    del ref
                    also = ""
                    if fc.fused_supported(fa, fixed):
                        _, why = compare(torch, out, fc.make_fused_chunk(fa, zeta, ode, steps,
                                                                         "cuda")(state), EXACT)
                        if why:
                            fail(f"B2 vs B1, {tag}: {why}")
                        also = ", equals B1"
                    worst = max(worst, err)
                    say(f"[B2 compare] {tag}, {steps} steps: max abs err {err:.1f}{also}, "
                        f"done {int(out.done.sum())}/{B} (shared memory {lay.smem_bytes} B, "
                        f"scratch {lay.row_words} words a row)")
    return worst


def phase_stream_determinism(torch, stc, big):
    from odesat_tpu_torch.utils.config import ODEConfig

    for (label, fa, B, steps), ode in ((big[0], ODEConfig(step_size=0.01)),
                                       (big[2], ODEConfig())):
        state = random_state(fa, B, seed=7)
        fn = stc.make_stream_chunk(fa, ode.resolve_zeta(fa.density), ode, steps, "cuda")
        a, b = fn(state), fn(state)
        torch.cuda.synchronize()
        for x, y, name in zip(a, b, a._fields):
            if not torch.equal(x, y):
                fail(f"B2 determinism, {label}: {name} differs between two identical launches")
        say(f"[B2 determinism] {label} {'fixed' if ode.step_size else 'adaptive'}: "
            "two launches bit-identical")


def ode_counters(fc, stc, rk):
    return {"fused_chunk": (fc, "launches"), "stream_chunk": (stc, "launches"),
            "rhs": (rk, "launches")}


def phase_stream_main(fc, stc, rk, n1k_reduced, card):
    """The large-formula ODE path through the CLI (solve, batch, inter);
    returns B2's launches over these runs."""
    from odesat_tpu_torch.cnf import cnf_to_dimacs

    os.makedirs(OUT, exist_ok=True)
    paths = {}
    for name, formula in (("planted_n2000_m7000", planted_n2000(7000)),
                          ("planted_n2000_m8000", planted_n2000(8000)),
                          ("ksat_n1000_m4300_seed7_planted", n1k_instance()),
                          ("local_n4096_m17203", local_n4096())):
        paths[name] = os.path.join(OUT, f"{name}.cnf")
        with open(paths[name], "w", encoding="utf-8") as fh:
            fh.write(cnf_to_dimacs(formula))
    hard = os.path.join(ROOT, "tests", "data", "hard.cnf")
    counters = ode_counters(fc, stc, rk)
    total = 0
    runs = (
        # label, subcommand, args, trajectories, expected verdict (None: any)
        ("solve planted n=2000 m=7000 adaptive", "solve",
         ["-f", paths["planted_n2000_m7000"], "-n", "20000", "--seed", "0"], 8, "true"),
        ("solve planted n=2000 m=7000 fixed", "solve",
         ["-f", paths["planted_n2000_m7000"], "-s", "0.01", "-n", "20000", "--seed", "0"], 8,
         "true"),
        ("batch planted n=2000 m=8000 B=1024", "batch",
         ["-f", paths["planted_n2000_m8000"], "-b", "1024", "-s", "0.01", "-n", "20000",
          "--seed", "0"], 1024, "true"),
        ("solve n1k B=10240 f32", "solve",
         ["-f", paths["ksat_n1000_m4300_seed7_planted"], "--solve-batch", "10240", "-s", "0.01",
          "-n", "4096", "--seed", "0"], 10240, None),
        ("solve n1k B=10240 bf16", "solve",
         ["-f", paths["ksat_n1000_m4300_seed7_planted"], "--solve-batch", "10240", "-s", "0.01",
          "-n", "4096", "--seed", "0", "--matmul-dtype", "bfloat16"], 10240, None),
        ("inter local n=4096 B=10240", "inter",
         ["-f", paths["local_n4096_m17203"], "-b", "10240", "-s", "0.01", "-n", "2048",
          "--seed", "0"], 10240, None),
        ("inter --dv-strategy stream hard.cnf B=16384", "inter",
         ["-f", hard, "-b", "16384", "-s", "0.01", "-n", "4096", "--seed", "0",
          "--dv-strategy", "stream"], 16384, "false"),
    )
    for label, cmd, args, B, want in runs:
        verdict, launches, steps, solved, seconds, out = run_cli(counters, cmd, args)
        shape = re.search(r"Clauses: (\d+) \| Vars: (\d+)", out)
        shape = f", preprocessed to {shape.group(1)} clauses / {shape.group(2)} vars" \
            if shape else ""
        say(f"[B2 main] {label}{shape}: verdict {verdict}, {solved} solved after {steps} steps "
            f"in {seconds:.6f} s = {B * steps / seconds:.6e} traj*steps/s, launches "
            f"{launches} ({card})")
        if launches["stream_chunk"] == 0:
            fail(f"{label}: the main path never launched B2")
        if want == "false" and (verdict != "false" or steps != 4096 or solved != 0):
            fail(f"{label}: expected false after exactly 4096 steps")
        if want == "true" and verdict != "true":
            fail(f"{label}: the port did not verify a satisfying assignment")
        if solved and verdict != "true":
            fail(f"{label}: a trajectory solved but its assignment did not verify")
        total += launches["stream_chunk"]
    return total


def rhs_inputs(torch, fa, B, dtype, seed):
    """v ~ U(-1, 1), xs ~ U(0.001, 0.999), xl ~ U(1, 50) on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def put(a):
        return torch.as_tensor(a).to("cuda", dtype)

    return (put(rng.uniform(-1, 1, (B, fa.n_vars_padded))),
            put(rng.uniform(0.001, 0.999, (B, fa.n_clauses_padded))),
            put(rng.uniform(1.0, 50.0, (B, fa.n_clauses_padded))))


def phase_rhs_compare(torch, rk, cases):
    """B10 vs the twin's gather RHS (its plain version) to a tolerance: the
    two sum in other orders. f32 rtol 2e-4 / atol 2e-5, f64 1e-12."""
    from odesat_tpu_torch.models.ode import formula_device

    worst = 0.0
    for label, fa, B in cases:
        buckets = fa.bucket_slices if len(fa.bucket_slices) > 1 else None
        for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, dict(rtol=1e-12, atol=1e-12))):
            v, xs, xl = rhs_inputs(torch, fa, B, dtype, seed=B)
            dev = formula_device(fa, "cuda", dtype)
            for rigidity in ("paper", "reference"):
                fn = rk.make_rhs_kernel(fa, 0.05, rigidity, str(dtype).split(".")[1])
                out = fn(v, xs, xl, dev)
                ref = rk.rhs_plain(v, xs, xl, dev, 0.05, rigidity, buckets)
                torch.cuda.synchronize()
                tag = f"{label} {str(dtype).split('.')[1]} {rigidity}"
                err = 0.0
                for name, a, b in zip(("dv", "dxs", "dxl"), out[:3], ref[:3]):
                    if not torch.isfinite(a).all():
                        fail(f"B10 vs twin, {tag}: {name} not finite")
                    if not torch.allclose(a, b, **tol):
                        fail(f"B10 vs twin, {tag}: {name} off by "
                             f"{(a - b).abs().max().item()} (tolerance {tol})")
                    err = max(err, (a - b).abs().max().item())
                if not torch.equal(out[3], ref[3]):
                    fail(f"B10 vs twin, {tag}: allsat differs")
                worst = max(worst, err)
                say(f"[B10 compare] {tag}: max abs err {err:.3e} (|dv| up to "
                    f"{ref[0].abs().max().item():.3e}), allsat equal")
    return worst


def phase_rhs_main(fc, stc, rk, card):
    """inter --dv-strategy pallas: single steps through B10."""
    os.makedirs(OUT, exist_ok=True)
    uf_path = os.path.join(OUT, "uf250_seed0.cnf")  # written by phase 5
    hard = os.path.join(ROOT, "tests", "data", "hard.cnf")
    total = 0
    for label, args, B, want in (
        ("hard.cnf B=4096", ["-f", hard, "-b", "4096", "-s", "0.01", "-n", "1024", "--seed", "0",
                             "--dv-strategy", "pallas"], 4096, "false"),
        ("uf250 B=4096", ["-f", uf_path, "-b", "4096", "-s", "0.01", "-n", "20000",
                          "--seed", "0", "--dv-strategy", "pallas"], 4096, "true"),
    ):
        verdict, launches, steps, solved, seconds, _ = run_cli(
            ode_counters(fc, stc, rk), "inter", args)
        say(f"[B10 main] inter --dv-strategy pallas {label}: verdict {verdict}, {solved} solved "
            f"after {steps} steps in {seconds:.6f} s = {B * steps / seconds:.6e} traj*steps/s, "
            f"launches {launches} ({card})")
        if launches["rhs"] == 0:
            fail(f"pallas {label}: the main path never launched B10")
        if want == "false" and (verdict != "false" or steps != 1024 or solved != 0):
            fail(f"pallas {label}: expected false after exactly 1024 steps")
        if want == "true" and verdict != "true":
            fail(f"pallas {label}: the port did not verify a satisfying assignment")
        total += launches["rhs"]
    return total


def phase_stream_timing(torch, fc, stc, hard, big, card):
    """B2 and its plain version in turns (plain, kernel, kernel, plain) on
    the same input and steps; at hard.cnf B1 takes turns beside B2."""
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.timing import cuda_ms

    n1k, _, local = big
    times = {}
    for label, fa, B, steps, fixed in ((n1k[0], n1k[1], n1k[2], 8, True),
                                       (n1k[0], n1k[1], n1k[2], 8, False),
                                       (local[0], local[1], local[2], 8, True),
                                       ("hard.cnf B=16384", hard, 16384, 256, True)):
        ode = ODEConfig(step_size=0.01 if fixed else None)
        state = random_state(fa, B, seed=3)
        fn = stc.make_stream_chunk(fa, ode.resolve_zeta(fa.density), ode, steps, "cuda")

        def plain_turn():
            return cuda_ms(lambda: stc.stream_chunk_plain(state, fn.spec, steps), 1, warmup=1)

        def kernel_turn():
            return cuda_ms(lambda: fn(state), iters=5, warmup=1)

        p1, k1, k2, p2 = plain_turn(), kernel_turn(), kernel_turn(), plain_turn()
        kern, plain = (k1 + k2) / 2, (p1 + p2) / 2
        mode = "fixed" if fixed else "adaptive"
        times[(label, mode)] = (kern, plain)
        b1 = ""
        if fc.fused_supported(fa, fixed):
            f1 = fc.make_fused_chunk(fa, ode.resolve_zeta(fa.density), ode, steps, "cuda")
            b1s = [cuda_ms(lambda: f1(state), iters=5, warmup=1) for _ in range(2)]
            b1 = f", B1 {b1s[0]:.6f} / {b1s[1]:.6f} ms"
        say(f"[B2 timing] {label} {mode} f32, {steps}-step chunk: B2 {k1:.6f} / {k2:.6f} ms, "
            f"plain {p1:.6f} / {p2:.6f} ms ({plain / kern:.3f}x){b1}, B2 "
            f"{B * steps / kern * 1e3:.6e} traj*steps/s ({card})")
    return times


def phase_rhs_timing(torch, rk, hard, card):
    """B10 and the twin per step, in turns, at hard.cnf B=16384 f32."""
    from odesat_tpu_torch.models.ode import formula_device
    from odesat_tpu_torch.utils.timing import cuda_ms

    B = 16384
    v, xs, xl = rhs_inputs(torch, hard, B, torch.float32, seed=3)
    dev = formula_device(hard, "cuda", torch.float32)
    fn = rk.make_rhs_kernel(hard, 0.05)

    def plain_turn():
        return cuda_ms(lambda: rk.rhs_plain(v, xs, xl, dev, 0.05, "paper", None), 10, warmup=2)

    def kernel_turn():
        return cuda_ms(lambda: fn(v, xs, xl, dev), iters=20, warmup=2)

    p1, k1, k2, p2 = plain_turn(), kernel_turn(), kernel_turn(), plain_turn()
    kern, plain = (k1 + k2) / 2, (p1 + p2) / 2
    say(f"[B10 timing] hard.cnf B={B} f32, one RHS pass: B10 {k1:.6f} / {k2:.6f} ms, twin "
        f"{p1:.6f} / {p2:.6f} ms ({plain / kern:.3f}x) ({card})")
    return kern, plain


# ------------------------------------------ clause shards: B5, B8, the mesh

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, HBM3 peak rate
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, the rate the bounds use


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nnz_of(fa):
    return int((fa.lit_mask > 0).sum())


def table_bytes(K, Mp, Np, nnz):
    """Literal codes, CSR pointers and occurrence lists, int32, read once."""
    return 4 * (K * Mp + Np + 1 + nnz)


def ode_step_ops(nnz, Np, Mp, fixed):
    """Operations of one ODE step of one trajectory: per literal slot 3
    (its value, the running min and second min), per occurrence 12 (the
    contribution and its add), per variable 3 (the update and its clamp),
    per clause 10 (c, dxs, dxl, the clamped updates); the adaptive step is
    two RHS passes plus the trial states and the error."""
    f = 15 * nnz + 3 * Np + 10 * Mp
    return f if fixed else 2 * f + 6 * Np + 20 * Mp


def ode_chunk_bound(fa, B, steps, fixed):
    """B1 and B2 over a chunk: the state (v, xs, xl, dt in float32, done)
    read and written once, the tables read once; operations for every
    step of every trajectory (no row is done in the timed inputs)."""
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, nnz_of(fa)
    nbytes = 2 * B * (4 * (Np + 2 * Mp + 1) + 1) + table_bytes(K, Mp, Np, nnz)
    return bound(nbytes, B * steps * ode_step_ops(nnz, Np, Mp, fixed))


def rhs_pass_bound(fa, B):
    """B10, one f32 RHS pass: v, xs, xl in; dv, dxs, dxl, allsat out."""
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, nnz_of(fa)
    nbytes = 2 * 4 * B * (Np + 2 * Mp) + B + table_bytes(K, Mp, Np, nnz)
    return bound(nbytes, B * (15 * nnz + 5 * Mp))


def stoch_step_ops(nnz, Np, Mp):
    """One stoch step of one chain: per literal slot 2 (its truth and the
    OR), per clause 3 (the weight update), per occurrence 3 (the weight
    and two adds), per variable 14 (the counter hash, the draw, the
    flip)."""
    return 5 * nnz + 3 * Mp + 14 * Np


def stoch_chunk_bound(fa, B, steps):
    """B3 and B4 over a chunk: v (bytes), xl (int32) and done read and
    written once, the tables once."""
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, nnz_of(fa)
    nbytes = 2 * B * (Np + 4 * Mp + 1) + table_bytes(K, Mp, Np, nnz)
    return bound(nbytes, B * steps * stoch_step_ops(nnz, Np, Mp))


def shard_bound(spec, B, mode):
    """B5, one launch over a shard (Mp its clause count): rhs reads v, xs,
    xl and writes dv, dxs, dxl, sat; fixed reads v, dt, xs, xl and writes
    dv, xs, xl, sat; second reads hv, dt, adv, xs, xl, dxs1, dxl1 and
    writes dv, xs, xl, the error."""
    Np, Mp = spec.Np, spec.Mp
    nnz = int(spec.occ_code.numel())
    words = {"rhs": (Np + 2 * Mp) + (Np + 2 * Mp + 1),
             "fixed": (Np + 1 + 2 * Mp) + (Np + 2 * Mp + 1),
             "second": (Np + 1 + 4 * Mp) + (Np + 2 * Mp + 1)}[mode]
    nbytes = 4 * B * words + (B if mode == "second" else 0) + table_bytes(spec.K, Mp, Np, nnz)
    ops = {"rhs": 15 * nnz + 5 * Mp, "fixed": 15 * nnz + 10 * Mp,
           "second": 15 * nnz + 20 * Mp}[mode]
    return bound(nbytes, B * ops)


def stoch_shard_bound(spec, B):
    """B8, one launch over a shard: v (bytes), active and xl in; the two
    (B, Np) partial sums, xl and the sat flag out."""
    Np, Mp = spec.Np, spec.Mp
    nnz = int(spec.occ_clause.numel())
    nbytes = B * Np + B + 4 * B * Mp + 8 * B * Np + 4 * B * Mp + B + \
        table_bytes(spec.K, Mp, Np, nnz)
    return bound(nbytes, B * (5 * nnz + 3 * Mp))


def shard_chunk_bound(spec, B):
    """B6, one fixed ``step`` launch with the apply prologue: reads v, the
    reduced (B, Np+1) buffer, done, xs and xl; writes v, the new partial
    (B, Np+1), done, xs and xl; B5's fixed operations plus the v update."""
    Np, Mp = spec.Np, spec.Mp
    nnz = int(spec.occ_code.numel())
    nbytes = 2 * (4 * B * (2 * Np + 1 + 2 * Mp) + B) + table_bytes(spec.K, Mp, Np, nnz)
    return bound(nbytes, B * (15 * nnz + 10 * Mp + 3 * Np))


def stoch_shard_chunk_bound(spec, B):
    """B9, one launch with the flip prologue: reads v (bytes), the reduced
    (B, 2*Np+1) buffer, done and xl; writes v, the new partials, done and
    xl; B8's operations plus the counter hash, draw and flip per
    variable."""
    Np, Mp = spec.Np, spec.Mp
    nnz = int(spec.occ_clause.numel())
    nbytes = 2 * (B * Np + 4 * B * (2 * Np + 1) + B + 4 * B * Mp) + \
        table_bytes(spec.K, Mp, Np, nnz)
    return bound(nbytes, B * (5 * nnz + 3 * Mp + 14 * Np))


def config7_instance():
    """run_benchmarks.py config 7: locally structured 3-SAT, n=10240,
    m=43700, locality 512, seed 9 (compile_stream_sharded: K=3, Np=10240,
    Mp=43,776 at S=1, 21,888 clauses a shard at S=2), as generated (the
    DIMACS variables, before normalization)."""
    from odesat_tpu_torch.utils.generate import random_local_ksat

    return random_local_ksat(10240, 43700, k=3, locality=512, seed=9)


def load_shard_cases(specs, card):
    """Phase 3's formulas compiled for S=1 and S=2, and the config 7
    instance at S=2 and S=1 (B=1024), S=1 last."""
    from odesat_tpu_torch.cnf import normalize_cnf_variables
    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded

    out = []
    for label, formula, bucket, B in specs:
        for S in (1, 2):
            out.append((f"{label} S={S}", compile_stream_sharded(formula, S, bucket=bucket)[0], B))
    t0 = time.perf_counter()
    c7 = config7_instance()
    normalized = normalize_cnf_variables(c7)[1]
    fa7 = compile_stream_sharded(normalized, 1)[0]
    fa7_2 = compile_stream_sharded(normalized, 2)[0]
    say(f"[config 7] instance and its S=1 and S=2 compiles in {time.perf_counter() - t0:.3f} s: "
        f"Np={fa7.n_vars_padded}, Mp={fa7.n_clauses_padded}, K={fa7.max_width}, "
        f"{fa7_2.shard_plan.mp_local} clauses a shard at S=2 (host; {card})")
    out.append(("config 7 S=2 B=1024", fa7_2, 1024))
    out.append(("config 7 S=1 B=1024", fa7, 1024))
    return out, c7, fa7, fa7_2


def shard_inputs(torch, fa, B, seed):
    """Random B5 inputs for one shard on the card: v, xs, xl, dt, adv,
    dxs1, dxl1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ml = fa.shard_plan.mp_local

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to("cuda", dtype)

    return dict(v=put(rng.uniform(-1, 1, (B, fa.n_vars_padded))),
                xs=put(rng.uniform(0.001, 0.999, (B, ml))), xl=put(rng.uniform(1, 50, (B, ml))),
                dt=put(rng.uniform(0, 0.05, B)), adv=put(rng.random(B) < 0.7, torch.bool),
                dxs1=put(rng.uniform(-1, 1, (B, ml))), dxl1=put(rng.uniform(-1, 1, (B, ml))))


SHARD_MODES = ("rhs", "fixed", "second")


def shard_call(ss, mode, inp, spec, plain=False):
    """B5 (or its plain version) in ``mode`` on copies of the inputs that
    the kernel updates in place."""
    keys = {"rhs": ("v", "xs", "xl"), "fixed": ("v", "dt", "xs", "xl"),
            "second": ("v", "dt", "adv", "xs", "xl", "dxs1", "dxl1")}[mode]
    args = [inp[k] if plain or k not in ("xs", "xl") else inp[k].clone() for k in keys]
    fn = {"rhs": (ss.shard_rhs, ss.shard_rhs_plain), "fixed": (ss.shard_fixed, ss.shard_fixed_plain),
          "second": (ss.shard_second, ss.shard_second_plain)}[mode][plain]
    return fn(*args, spec)


def phase_shard_compare(torch, ss, shard_cases):
    """B5 vs its plain version, exactly, every shard of every case: three
    modes, both rigidity gates, f32 and bf16; then two launches at config
    7 bit-identical."""
    from odesat_tpu_torch.utils.config import ODEConfig

    worst, n = 0.0, 0
    for label, fa, B in shard_cases:
        for s in range(fa.shard_plan.n_shards):
            inp = shard_inputs(torch, fa, B, seed=B + s)
            for rigidity in ("paper", "reference"):
                for mm in ("float32", "bfloat16"):
                    ode = ODEConfig(step_size=0.01, rigidity=rigidity, matmul_dtype=mm)
                    spec = ss.shard_spec(fa, ode.resolve_zeta(fa.density), ode, "cuda", s)
                    for mode in SHARD_MODES:
                        out = shard_call(ss, mode, inp, spec)
                        ref = shard_call(ss, mode, inp, spec, plain=True)
                        torch.cuda.synchronize()
                        for a, b in zip(out, ref):
                            if not torch.equal(a, b):
                                err = (a.float() - b.float()).abs().max().item()
                                fail(f"B5 vs plain, {label} shard {s} {mode} {rigidity} {mm}: "
                                     f"off by {err}")
                        n += 1
            say(f"[B5 compare] {label} shard {s}/{fa.shard_plan.n_shards} B={B}: rhs, fixed, "
                f"second x paper, reference x f32, bf16 equal (max abs err 0.0), shared memory "
                f"{ss.shard_layout(fa.n_vars_padded, fa.shard_plan.mp_local, True).smem_bytes} B")
    label, fa7, B = shard_cases[-1]
    inp = shard_inputs(torch, fa7, B, seed=7)
    ode = ODEConfig(step_size=0.01)
    spec = ss.shard_spec(fa7, ode.resolve_zeta(fa7.density), ode, "cuda", 0)
    for mode in ("fixed", "second"):
        a, b = shard_call(ss, mode, inp, spec), shard_call(ss, mode, inp, spec)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"B5 determinism, {label} {mode}: two launches differ")
        say(f"[B5 determinism] {label} {mode}: two launches bit-identical")
    say(f"[B5 compare] {n} cases equal to the plain version")
    return 0.0


def stoch_shard_inputs(torch, fa, B, shard, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    ml = fa.shard_plan.mp_local
    return (torch.as_tensor(rng.random((B, fa.n_vars_padded)) < 0.5, device="cuda"),
            torch.as_tensor(rng.integers(1, 3001, (B, ml)).astype(np.int32), device="cuda"),
            torch.as_tensor(rng.random(B) < 0.8, device="cuda"))


def phase_stoch_shard_compare(torch, sc, shard_cases):
    """B8 vs its plain version, exactly, every shard, f32 and bf16; then
    two launches at config 7 bit-identical. Returns the max abs error (0.0:
    anything else fails)."""
    n = 0
    for label, fa, B in shard_cases:
        for s in range(fa.shard_plan.n_shards):
            v, xl, active = stoch_shard_inputs(torch, fa, B, s, seed=B + s)
            for mm in ("float32", "bfloat16"):
                ev = sc.make_stoch_shard_eval(fa, "cuda", s, mm)
                out = ev(v, xl, active)
                ref = sc.stoch_shard_eval_plain(v, xl, active, ev.spec, mm == "bfloat16")
                torch.cuda.synchronize()
                for a, b in zip(out, ref):
                    if not torch.equal(a, b):
                        fail(f"B8 vs plain, {label} shard {s} {mm}: differs")
                n += 1
            say(f"[B8 compare] {label} shard {s}/{fa.shard_plan.n_shards} B={B}: f32, bf16 equal "
                f"(max abs err 0.0), xl resident {sc.stoch_shard_smem_bytes(ev.spec)[1]}")
    label, fa7, B = shard_cases[-1]
    v, xl, active = stoch_shard_inputs(torch, fa7, B, 0, seed=9)
    ev = sc.make_stoch_shard_eval(fa7, "cuda", 0)
    a, b = ev(v, xl, active), ev(v, xl, active)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"B8 determinism, {label}: two launches differ")
    say(f"[B8 determinism] {label}: two launches bit-identical")
    say(f"[B8 compare] {n} cases equal to the plain version")
    return 0.0


def chunk_buffers(torch, fa, B, fixed, seed):
    """Random B6 buffers for one shard on the card: a state with some rows
    done and a reduced buffer whose sat count is 0 on some rows."""
    import numpy as np

    from odesat_tpu_torch.ops.shard_chunk import ChunkBuffers

    rng = np.random.default_rng(seed)
    Np, ml = fa.n_vars_padded, fa.shard_plan.mp_local

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to("cuda", dtype)

    acc = rng.uniform(-2, 2, (B, Np + 1))
    acc[:, Np] = rng.integers(0, 3, B)
    b = ChunkBuffers(put(rng.uniform(-1, 1, (B, Np))), put(rng.uniform(0.001, 0.999, (B, ml))),
                     put(rng.uniform(1, 50, (B, ml))), put(rng.uniform(0.01, 0.05, B)),
                     put(rng.random(B) < 0.2, torch.bool), put(acc))
    if not fixed:
        b = b._replace(acc2=put(rng.uniform(-2, 2, (B, Np))), err=put(rng.uniform(0, 1e-2, B)),
                       dxs1=put(rng.uniform(-1, 1, (B, ml))), dxl1=put(rng.uniform(-1, 1, (B, ml))))
    return b


CHUNK_PHASES = {"fixed": (("step", False), ("step", True), ("apply", False)),
                "adaptive": (("first", False), ("first", True), ("half", False),
                             ("commit", False))}


def copy_buffers(b):
    return type(b)(*(t.clone() if t is not None else None for t in b))


def phase_shard_chunk_compare(torch, sch, ss, shard_cases):
    """B6 vs its plain version, exactly, every shard of every case: each
    phase of both integrators with and without the apply prologue, both
    rigidity gates, f32 and bf16; then two launches at config 7
    bit-identical."""
    from odesat_tpu_torch.utils.config import ODEConfig

    n = 0
    for label, fa, B in shard_cases:
        for s in range(fa.shard_plan.n_shards):
            for mode, phases in CHUNK_PHASES.items():
                fixed = mode == "fixed"
                # one draw a shard and integrator: the plain version writes nothing,
                # the kernel runs on copies
                b = chunk_buffers(torch, fa, B, fixed, seed=B + 10 * s + fixed)
                for rigidity in ("paper", "reference"):
                    for mm in ("float32", "bfloat16"):
                        ode = ODEConfig(step_size=0.01 if fixed else None, rigidity=rigidity,
                                        matmul_dtype=mm)
                        spec = ss.shard_spec(fa, ode.resolve_zeta(fa.density), ode, "cuda", s)
                        for ph, apply in phases:
                            ref = sch.shard_chunk_plain(ph, b, spec, apply)
                            out = sch.shard_chunk_cuda(ph, copy_buffers(b), spec, apply)
                            torch.cuda.synchronize()
                            for name, x, y in zip(b._fields, out, ref):
                                if not ((x is None and y is None) or torch.equal(x, y)):
                                    err = (x.float() - y.float()).abs().max().item()
                                    fail(f"B6 vs plain, {label} shard {s} {ph} apply={apply} "
                                         f"{rigidity} {mm}: {name} off by {err}")
                            n += 1
            say(f"[B6 compare] {label} shard {s}/{fa.shard_plan.n_shards} B={B}: step, apply, "
                f"first, half, commit (with and without the prologue) x paper, reference x f32, "
                f"bf16 equal (max abs err 0.0)")
    label, fa7, B = shard_cases[-1]
    for mode, phases in CHUNK_PHASES.items():
        ode = ODEConfig(step_size=0.01 if mode == "fixed" else None)
        spec = ss.shard_spec(fa7, ode.resolve_zeta(fa7.density), ode, "cuda", 0)
        b = chunk_buffers(torch, fa7, B, mode == "fixed", seed=8)
        for ph, apply in phases:
            x = sch.shard_chunk_cuda(ph, copy_buffers(b), spec, apply)
            y = sch.shard_chunk_cuda(ph, copy_buffers(b), spec, apply)
            torch.cuda.synchronize()
            if not all((p is None and q is None) or torch.equal(p, q) for p, q in zip(x, y)):
                fail(f"B6 determinism, {label} {ph}: two launches differ")
        say(f"[B6 determinism] {label} {mode}: two launches of every phase bit-identical")
    say(f"[B6 compare] {n} cases equal to the plain version")
    return 0.0


def stoch_chunk_inputs(torch, fa, B, seed):
    """Random B9 inputs for one shard: v, xl up to 3000, done, and a
    reduced buffer of integer sums with unsat <= total."""
    import numpy as np

    rng = np.random.default_rng(seed)
    Np, ml = fa.n_vars_padded, fa.shard_plan.mp_local
    acc = rng.integers(0, 60000, (B, 2 * Np + 1)).astype(np.float32)
    acc[:, Np:2 * Np] = np.minimum(acc[:, Np:2 * Np], acc[:, :Np]) * rng.integers(0, 2, (B, Np))
    acc[:, 2 * Np] = rng.integers(0, 2, B)
    return (torch.as_tensor(rng.random((B, Np)) < 0.5, device="cuda"),
            torch.as_tensor(rng.integers(1, 3001, (B, ml)).astype(np.int32), device="cuda"),
            torch.as_tensor(rng.random(B) < 0.2, device="cuda"),
            torch.as_tensor(acc, device="cuda"))


STOCH_CHUNK_CASES = ((False, True), (True, True), (True, False))  # (apply, evaluate)


def phase_stoch_shard_chunk_compare(torch, sc, shard_cases):
    """B9 vs its plain version, exactly, every shard: with and without the
    flip prologue and flip-only, f32 and bf16; then two launches at config
    7 bit-identical."""
    n = 0
    for label, fa, B in shard_cases:
        for s in range(fa.shard_plan.n_shards):
            spec = sc.stoch_shard_spec(fa, "cuda", s)
            inp = stoch_chunk_inputs(torch, fa, B, seed=B + 10 * s)  # one draw a shard
            for i, (apply, evaluate) in enumerate(STOCH_CHUNK_CASES):
                for mm in ("float32", "bfloat16"):
                    args = (spec, mm == "bfloat16", 987654 + i, sc.traj_block(B), 5, apply,
                            evaluate)
                    ref = sc.stoch_shard_step_plain(*inp, *args)
                    out = sc.stoch_shard_step_cuda(*(t.clone() for t in inp), *args)
                    torch.cuda.synchronize()
                    for name, x, y in zip(("v", "xl", "done", "acc"), out, ref):
                        if not torch.equal(x, y):
                            fail(f"B9 vs plain, {label} shard {s} apply={apply} "
                                 f"evaluate={evaluate} {mm}: {name} differs")
                    n += 1
            say(f"[B9 compare] {label} shard {s}/{fa.shard_plan.n_shards} B={B}: with and "
                f"without the flip prologue, flip-only x f32, bf16 equal (max abs err 0.0)")
    label, fa7, B = shard_cases[-1]
    spec = sc.stoch_shard_spec(fa7, "cuda", 0)
    inp = stoch_chunk_inputs(torch, fa7, B, seed=9)
    args = (spec, False, 4321, sc.traj_block(B), 5, True, True)
    x = sc.stoch_shard_step_cuda(*(t.clone() for t in inp), *args)
    y = sc.stoch_shard_step_cuda(*(t.clone() for t in inp), *args)
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(x, y)):
        fail(f"B9 determinism, {label}: two launches differ")
    say(f"[B9 determinism] {label}: two launches bit-identical")
    say(f"[B9 compare] {n} cases equal to the plain version")
    return 0.0


def run_cli_mesh(cmd, args):
    """The CLI with a mesh flag: the kernels launch in the spawned ranks,
    which report their counts (parallel/launch.last_reports)."""
    from odesat_tpu_torch.parallel import launch

    launch.last_reports = []
    verdict, _, steps, solved, seconds, out = run_cli({}, cmd, args)
    return verdict, launch.last_reports, steps, solved, seconds, out


def phase_mesh_main(torch, fa7_1, fa7_2, c7, uf250_formula, card):
    """Phase 20: the clause-mesh main path (gloo ranks sharing the card)
    and the trajectory mesh; returns launches of B5, B6, B8 and B9 summed
    over the ranks of the main-path runs. The parity checks after the CLI
    runs use 256 rows (ODE) and 32 steps (stoch) of the config 7 instance:
    every spawn pays about 10 s of start-up and gloo stages every
    collective through the host."""
    import numpy as np

    from odesat_tpu_torch import cli
    from odesat_tpu_torch.cnf import cnf_to_dimacs
    from odesat_tpu_torch.parallel import launch, sharded

    os.makedirs(OUT, exist_ok=True)
    c7_path = os.path.join(OUT, "local_n10240_m43700.cnf")
    with open(c7_path, "w", encoding="utf-8") as fh:
        fh.write(cnf_to_dimacs(c7))
    uf_path = os.path.join(OUT, "uf250_seed0.cnf")  # written by phase 5
    easy = os.path.join(ROOT, "tests", "data", "easy.cnf")
    gloo = ["--clause-shards", "2", "--dist-backend", "gloo"]
    off = ["--shard-chunk", "off"]
    totals = {"shard_stream": 0, "shard_chunk": 0, "stoch_shard_eval": 0, "stoch_shard_chunk": 0}
    c7_inter = ["-f", c7_path, "-b", "1024", "-s", "0.01", "--seed", "0"]
    c7_stoch = ["-f", c7_path, "--no-preprocess", "-b", "1024", "--seed", "0"]
    # the per-step paths (B5, B8) run fewer steps than the default chunk kernels (B6, B9)
    runs = (
        # label, subcommand, args, kernel, B, expected verdict (None: false after the budget
        # or a solved trajectory that verifies)
        ("a. inter uf250 B=4096", "inter",
         ["-f", uf_path, "-b", "4096", "-s", "0.01", "-n", "20000", "--seed", "0"],
         "shard_chunk", 4096, "true"),
        ("b. inter config 7 B=1024", "inter", c7_inter + ["-n", "256"], "shard_chunk", 1024,
         None),
        ("b. inter config 7 B=1024 --shard-chunk off", "inter", c7_inter + ["-n", "64"] + off,
         "shard_stream", 1024, None),
        ("c. stoch config 7 B=1024 --no-preprocess", "stoch", c7_stoch + ["-n", "128"],
         "stoch_shard_chunk", 1024, None),
        ("c. stoch config 7 B=1024 --no-preprocess --shard-chunk off", "stoch",
         c7_stoch + ["-n", "64"] + off, "stoch_shard_eval", 1024, None),
        ("c. stoch easy.cnf B=256", "stoch", ["-f", easy, "-b", "256", "-n", "20000", "--seed", "1"],
         "stoch_shard_chunk", 256, "true"),
    )
    for label, cmd, args, kernel, B, want in runs:
        verdict, reports, steps, solved, seconds, _ = run_cli_mesh(cmd, [*args, *gloo])
        counts = [r[kernel] for r in reports]
        others = {k: [r[k] for r in reports] for k in totals if k != kernel}
        say(f"[mesh main] {label} --clause-shards 2 (gloo, staged through the host): verdict "
            f"{verdict}, {solved} solved after {steps} steps in {seconds:.6f} s = "
            f"{B * steps / seconds:.6e} steps*rows/s (a correctness run, not the port's rate), "
            f"{kernel} launches per rank {counts}, other clause kernels {others}, v replicated "
            f"(every rank checked it) ({card})")
        if len(counts) != 2 or min(counts) == 0:
            fail(f"{label}: {kernel} was not launched on both ranks")
        if any(sum(c) for c in others.values()):
            fail(f"{label}: another clause kernel than {kernel} ran")
        if want == "true" and verdict != "true":
            fail(f"{label}: the port did not verify a satisfying assignment")
        budget = int(args[args.index("-n") + 1])
        if want is None and not (verdict == "false" and steps == budget and solved == 0) and \
                not (solved and verdict == "true"):
            fail(f"{label}: expected false after exactly {budget} steps or a verified solution")
        totals[kernel] += sum(counts)

    # b. the ODE clause mesh at S=2 against the S=1 runner, row for row, and
    # c. the stoch clause path at S=2 against S=1, flip for flip: one world
    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.ops import shard_stream as ss
    from odesat_tpu_torch.utils.config import ODEConfig

    t0 = time.perf_counter()
    B = 256  # rows enough for a row-for-row check; the CLI runs above are the full batch
    rng = np.random.default_rng(31)
    v0 = rng.uniform(-1, 1, (B, fa7_2.n_vars_padded)).astype(np.float32)
    dt0, done0 = np.full(B, 0.01, np.float32), np.zeros(B, bool)

    def layout(fa):
        xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
        return v0, xs, np.ones_like(xs), dt0, done0

    arrays2 = layout(fa7_2)
    odes = (("fixed", ODEConfig(step_size=0.01), 8), ("adaptive", ODEConfig(), 4))
    zeta = odes[0][1].resolve_zeta(fa7_2.density)
    cases = [(fa7_2, zeta, ode, n, arrays2) for _, ode, n in odes]
    cases += [(fa7_2, zeta, ODEConfig(step_size=ode.step_size, shard_chunk="off"), n, arrays2)
              for _, ode, n in odes]
    stoch_modes = (("auto", "stoch_shard_chunk"), ("off", "stoch_shard_eval"))
    calls = [(sharded.run_ode_cases, (cases,))]
    calls += [(sharded.run_stoch_clause, (fa7_2, 4, 8, 5, "float32", 1024, mode))
              for mode, _ in stoch_modes]
    two, *stoch_two = launch.spawn(launch.run_all, 1, 2, "gloo", "cuda", timeout_s=600,
                                   args=(calls,))
    counts = {k: [r[k] for r in launch.last_reports] for k in totals}
    if min(min(c) for c in counts.values()) == 0:
        fail(f"the parity world: every clause kernel must run on both ranks, counts {counts}")
    p2, p1 = fa7_2.shard_plan, fa7_1.shard_plan

    def by_clause(x, plan, dtype=np.float32):
        out = np.zeros((x.shape[0], int(p1.clause_of.max()) + 1), dtype)
        out[:, plan.clause_of[plan.clause_of >= 0]] = x[:, plan.clause_of >= 0]
        return out

    worst = 0.0
    for i, (mode, ode, n) in enumerate(odes):
        one = ss.make_single_device_runner(fa7_1, zeta, ode, n, "cuda")(
            state_from_numpy(*layout(fa7_1), device="cuda"))
        one = [t.cpu().numpy() for t in one]
        for path, out in (("B6", two[i]), ("B5", two[i + 2])):
            pairs = ((out[0], one[0]), (by_clause(out[1], p2), by_clause(one[1], p1)),
                     (by_clause(out[2], p2), by_clause(one[2], p1)))
            for name, (a, b) in zip(("v", "xs", "xl"), pairs):
                if not (np.isfinite(a).all() and np.allclose(a, b, **F32_TOL)):
                    fail(f"config 7 {mode} {path} S=2 vs S=1: {name} off by "
                         f"{np.abs(a - b).max()}")
                worst = max(worst, float(np.abs(a - b).max()))
            if not (np.array_equal(out[4], one[4]) and np.allclose(out[3], one[3], rtol=2e-4,
                                                                    atol=2e-6)):
                fail(f"config 7 {mode} {path} S=2 vs S=1: done or dt differ")
            if not np.array_equal(out[5][0], out[5][1]):
                fail(f"config 7 {mode} {path}: the clause ranks' v differ")
        for a, b in zip(two[i][:5], two[i + 2][:5]):
            if not np.array_equal(a, b):
                fail(f"config 7 {mode} S=2: B6 differs from B5")
    say(f"[mesh main] b. inter's clause mesh config 7 B={B} at S=2 (gloo), fixed 8 steps and "
        f"adaptive 4, through B6 and B5: equal to the S=1 runner row for row within rtol 2e-4 / "
        f"atol 2e-5 (max abs err {worst:.6e}; xs, xl clause by clause; done exact), B6 equal "
        f"to B5 bit for bit, both ranks' v bit-identical ({card})")
    for (mode, kernel), two_s in zip(stoch_modes, stoch_two):
        one = sharded.run_stoch_clause(None, "cuda", fa7_1, 4, 8, 5, "float32", 1024, mode)
        if not (np.array_equal(two_s[0], one[0]) and np.array_equal(two_s[2], one[2])
                and np.array_equal(by_clause(two_s[1], p2, np.int64),
                                   by_clause(one[1], p1, np.int64))):
            fail(f"stoch clause path ({kernel}): S=2 differs from S=1")
        say(f"[mesh main] c. stoch clause path config 7 B=1024, 32 steps through {kernel}: "
            f"S=2 (gloo) equals S=1 flip for flip (v, xl clause by clause, done; "
            f"{int(two_s[0].sum())} variables true, max weight {int(two_s[1].max())}) ({card})")
    say(f"[mesh main] b, c. one parity world of two ranks, launches per rank {counts}, in "
        f"{time.perf_counter() - t0:.1f} s ({card})")

    # e. trajectory mesh: T=2 through B1 equals T=1 row for row
    from odesat_tpu_torch.models.ode import simulate_batch
    from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig

    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=20000), batch_size=4096, seed=0)
    one = simulate_batch(uf250_formula, config, device="cuda", stop_on="any")
    two = launch.spawn(cli._mesh_solve, 2, 1, "gloo", "cuda", timeout_s=600,
                       args=("ode", uf250_formula, config, {"stop_on": "any"}))
    b1 = [r["fused_chunk"] for r in launch.last_reports]
    if not (np.array_equal(two.assignment, one.assignment) and np.array_equal(two.done, one.done)
            and two.steps == one.steps):
        rows = int((two.assignment != one.assignment).any(axis=1).sum())
        fail(f"trajectory mesh T=2 differs from T=1: {rows} rows, steps {two.steps} vs "
             f"{one.steps}, done {int(two.done.sum())} vs {int(one.done.sum())}")
    if min(b1) == 0:
        fail("trajectory mesh: B1 was not launched on both ranks")
    say(f"[mesh main] e. inter --devices 2 uf250 B=4096: equals T=1 row for row ({one.steps} "
        f"steps, {int(one.done.sum())} solved), B1 launches per rank {b1}")
    return totals


def phase_nccl_world_of_one(torch, fa7):
    """20d: the clause step (B5) and the clause-sharded chunk (B6)
    through an NCCL process group of one rank equal the mesh-free B5 runner
    bit for bit."""
    import tempfile

    import torch.distributed as dist

    from odesat_tpu_torch.ops import shard_chunk as sch
    from odesat_tpu_torch.ops import shard_stream as ss
    from odesat_tpu_torch.parallel.mesh import Mesh
    from odesat_tpu_torch.parallel.multihost import initialize_distributed
    from odesat_tpu_torch.utils.config import ODEConfig

    tmp = tempfile.mkdtemp(prefix="odesat_nccl_")
    initialize_distributed("nccl", "cuda", rank=0, world_size=1,
                           store_path=os.path.join(tmp, "store"), timeout_s=120)
    try:
        mesh = Mesh(1, 1)
        for ode in (ODEConfig(step_size=0.01), ODEConfig()):
            zeta = ode.resolve_zeta(fa7.density)
            grouped = ss.make_clause_chunk(
                ss.make_fused_clause_step(fa7, zeta, ode, mesh.clause_group, "cuda"), 16)
            chunk = sch.make_shard_chunk(fa7, zeta, ode, 16, mesh.clause_group, "cuda")
            alone = ss.make_single_device_runner(fa7, zeta, ode, 16, "cuda")
            state = random_state(fa7, 1024, seed=21)
            a, c, b = grouped(state), chunk(state), alone(state)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                fail("the clause step over an NCCL world of one differs from the B5 runner")
            if not all(torch.equal(x, y) for x, y in zip(c, b)):
                fail("the B6 chunk over an NCCL world of one differs from the B5 runner")
            say(f"[mesh main] d. config 7 B=1024 {'fixed' if ode.step_size else 'adaptive'}, "
                "16 steps: the clause step (B5) and the B6 chunk over an NCCL world of one "
                "equal the mesh-free B5 runner bit for bit")
    finally:
        dist.destroy_process_group()


def phase_shard_timing(torch, ss, sch, sc, fa7, card):
    """Phase 21 at the config 7 instance, B=1024, S=1: B5 fixed and second,
    B6's fixed step, B8 and B9 per launch (kernel and plain in turns, CUDA
    events, beside the bound), the single-device runner's (B5) and the B6
    chunk's throughput, and the gloo all-reduce per step at S=2."""
    from odesat_tpu_torch.parallel import launch
    from odesat_tpu_torch.parallel.dist import time_all_reduce
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.timing import cuda_ms

    B = 1024
    ode = ODEConfig(step_size=0.01)
    zeta = ode.resolve_zeta(fa7.density)
    spec = ss.shard_spec(fa7, zeta, ode, "cuda", 0)
    inp = shard_inputs(torch, fa7, B, seed=3)
    times = {}
    for mode in ("fixed", "second"):
        keys = {"fixed": ("v", "dt", "xs", "xl"),
                "second": ("v", "dt", "adv", "xs", "xl", "dxs1", "dxl1")}[mode]
        args = [inp[k] for k in keys]
        kern = {"fixed": ss.shard_fixed, "second": ss.shard_second}[mode]
        plain = {"fixed": ss.shard_fixed_plain, "second": ss.shard_second_plain}[mode]

        def kernel_turn():  # in place on xs, xl: they stay in range
            return cuda_ms(lambda: kern(*args, spec), iters=20, warmup=2)

        def plain_turn():
            return cuda_ms(lambda: plain(*args, spec), 2, warmup=1)

        p1, k1, k2, p2 = plain_turn(), kernel_turn(), kernel_turn(), plain_turn()
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        b, by = shard_bound(spec, B, mode)
        times[mode] = (k, p, b, by)
        say(f"[B5 timing] config 7 B={B} S=1 {mode} f32, one launch: B5 {k1:.6f} / {k2:.6f} ms, "
            f"plain {p1:.6f} / {p2:.6f} ms ({p / k:.3f}x), bound {b:.6f} ms by {by} "
            f"({b / k:.3f} of it) ({card})")
    v, xl, active = stoch_shard_inputs(torch, fa7, B, 0, seed=4)
    ev = sc.make_stoch_shard_eval(fa7, "cuda", 0)

    def b8_turn():
        return cuda_ms(lambda: ev(v, xl, active), iters=20, warmup=2)

    def b8_plain():
        return cuda_ms(lambda: sc.stoch_shard_eval_plain(v, xl, active, ev.spec, False), 2,
                       warmup=1)

    p1, k1, k2, p2 = b8_plain(), b8_turn(), b8_turn(), b8_plain()
    k, p = (k1 + k2) / 2, (p1 + p2) / 2
    b, by = stoch_shard_bound(ev.spec, B)
    times["b8"] = (k, p, b, by)
    say(f"[B8 timing] config 7 B={B} S=1 f32, one launch: B8 {k1:.6f} / {k2:.6f} ms, plain "
        f"{p1:.6f} / {p2:.6f} ms ({p / k:.3f}x), bound {b:.6f} ms by {by} ({b / k:.3f} of it) "
        f"({card})")

    # B6: one fixed step launch with the apply prologue, in place
    spec6 = ss.shard_spec(fa7, zeta, ode, "cuda", 0)
    b = chunk_buffers(torch, fa7, B, True, seed=6)
    b = b._replace(done=torch.zeros_like(b.done), acc=b.acc.index_fill(1, torch.tensor(
        [spec6.Np], device="cuda"), 1.0))  # no row latches done while timed

    def b6_turn():
        return cuda_ms(lambda: sch.shard_chunk_cuda("step", b, spec6, True), iters=20, warmup=2)

    def b6_plain():
        return cuda_ms(lambda: sch.shard_chunk_plain("step", b, spec6, True), 2, warmup=1)

    p1, k1, k2, p2 = b6_plain(), b6_turn(), b6_turn(), b6_plain()
    k, p = (k1 + k2) / 2, (p1 + p2) / 2
    bb, by = shard_chunk_bound(spec6, B)
    times["b6"] = (k, p, bb, by)
    say(f"[B6 timing] config 7 B={B} S=1 fixed f32, one step launch (apply + fixed pass): B6 "
        f"{k1:.6f} / {k2:.6f} ms, plain {p1:.6f} / {p2:.6f} ms ({p / k:.3f}x), bound "
        f"{bb:.6f} ms by {by} ({bb / k:.3f} of it) ({card})")

    # B9: one launch with the flip prologue, in place
    spec9 = sc.stoch_shard_spec(fa7, "cuda", 0)
    v9, xl9, done9, acc9 = stoch_chunk_inputs(torch, fa7, B, seed=10)
    done9.zero_()
    acc9[:, 2 * spec9.Np] = 1.0
    args9 = (spec9, False, 5555, sc.traj_block(B), 1, True, True)

    def b9_turn():
        return cuda_ms(lambda: sc.stoch_shard_step_cuda(v9, xl9, done9, acc9, *args9), iters=20,
                       warmup=2)

    def b9_plain():
        return cuda_ms(lambda: sc.stoch_shard_step_plain(v9, xl9, done9, acc9, *args9), 2,
                       warmup=1)

    p1, k1, k2, p2 = b9_plain(), b9_turn(), b9_turn(), b9_plain()
    k, p = (k1 + k2) / 2, (p1 + p2) / 2
    bb, by = stoch_shard_chunk_bound(spec9, B)
    times["b9"] = (k, p, bb, by)
    say(f"[B9 timing] config 7 B={B} S=1 f32, one launch (flip + evaluation): B9 {k1:.6f} / "
        f"{k2:.6f} ms, plain {p1:.6f} / {p2:.6f} ms ({p / k:.3f}x), bound {bb:.6f} ms by {by} "
        f"({bb / k:.3f} of it) ({card})")

    state = random_state(fa7, B, seed=5)
    rates = {}
    for name, run in (("B5 runner", ss.make_single_device_runner(fa7, zeta, ode, 64, "cuda")),
                      ("B6 chunk", sch.make_shard_chunk(fa7, zeta, ode, 64, None, "cuda"))):
        run(state)
        torch.cuda.synchronize()
        rates[name] = []
        for _ in range(2):
            t0 = time.perf_counter()
            run(state)
            torch.cuda.synchronize()
            rates[name].append(B * 64 / (time.perf_counter() - t0))
        r = rates[name]
        say(f"[{name}] config 7 B={B} S=1 fixed f32, 64-step chunk: {r[0]:.6e} / {r[1]:.6e} "
            f"traj*steps/s (the counterpart of local3sat_n10240_shard_rhs) ({card})")
    ms = launch.spawn(time_all_reduce, 1, 2, "gloo", "cuda", timeout_s=600,
                      args=((B, fa7.n_vars_padded + 1), 10))
    say(f"[mesh timing] gloo all-reduce of the (B={B}, Np+1) f32 dv buffer at S=2, two ranks on "
        f"one card, staged through the host: {ms:.6f} ms per step ({card})")
    times["runner"] = rates
    times["allreduce_ms"] = ms
    return times


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import odesat_tpu_torch
    from odesat_tpu_torch.ops import fused_chunk as fc
    from odesat_tpu_torch.ops import rhs_kernel as rk
    from odesat_tpu_torch.ops import stoch_chunk as sc
    from odesat_tpu_torch.ops import stream_chunk as stc

    if not os.path.abspath(odesat_tpu_torch.__file__).startswith(ROOT + os.sep):
        fail(f"odesat_tpu_torch came from {odesat_tpu_torch.__file__}, not this checkout")
    if "jax" in sys.modules:
        fail("jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()

    def clock(what):
        say(f"[clock] {what} done at {time.perf_counter() - t0:.1f} s")

    card = phase_device(torch)
    phase_build(fc, sc, stc)
    cases, hard, uf250, specs = load_cases()
    worst = phase_compare(torch, fc, cases)
    worst = max(worst, phase_compare_finishing(torch, fc, uf250))
    say(f"[compare] all cases within tolerance; max abs err {worst:.6e}")
    phase_determinism(torch, fc, hard, uf250)
    launches = phase_main_sat(fc)
    launches += phase_main_unsat(fc, card)
    times = phase_timing(torch, fc, hard, uf250, card)
    clock("phases 1-7 (B1)")

    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables
    from odesat_tpu_torch.utils.generate import random_ksat

    n1k_reduced = preprocessed_n1k()
    stoch_cases, n1k = load_stoch_cases(cases, n1k_reduced)
    stoch_worst = phase_stoch_compare(torch, sc, stoch_cases)
    planted = compile_formula(normalize_cnf_variables(random_ksat(200, 700, seed=3,
                                                                  planted=True))[1])
    finishing = phase_stoch_finishing(torch, sc, planted)
    stoch_worst = {k: max(stoch_worst[k], finishing[k]) for k in STOCH_KERNELS}
    say(f"[stoch compare] every case equal; max abs err {stoch_worst}")
    phase_stoch_determinism(torch, sc, hard, n1k)
    stoch_launches = phase_stoch_main(fc, sc, card)
    stoch_times = phase_stoch_timing(torch, sc, hard, n1k, card)
    clock("phases 8-11 (B3, B4)")

    big = load_stream_cases(n1k_reduced)
    b2_worst = phase_stream_compare(torch, fc, stc, cases, big)
    b2_worst = max(b2_worst, phase_compare_finishing(torch, fc, uf250, stc.make_stream_chunk,
                                                     EXACT, "B2"))
    say(f"[B2 compare] every case equal to the plain version; max abs err {b2_worst}")
    phase_stream_determinism(torch, stc, big)
    b2_launches = phase_stream_main(fc, stc, rk, n1k_reduced, card)
    b2_times = phase_stream_timing(torch, fc, stc, hard, big, card)
    b10_worst = phase_rhs_compare(torch, rk, (("hard.cnf B=16384", hard, 16384),
                                              ("uf250 B=4096", uf250, 4096),
                                              ("n1k preprocessed B=1024", big[0][1], 1024)))
    b10_launches = phase_rhs_main(fc, stc, rk, card)
    b10_ms, b10_plain = phase_rhs_timing(torch, rk, hard, card)
    clock("phases 12-17 (B2, B10)")

    from odesat_tpu_torch.ops import shard_chunk as sch
    from odesat_tpu_torch.ops import shard_stream as ss

    shard_cases, c7, fa7, fa7_2 = load_shard_cases(specs, card)
    b5_worst = phase_shard_compare(torch, ss, shard_cases)
    b6_worst = phase_shard_chunk_compare(torch, sch, ss, shard_cases)
    b8_worst = phase_stoch_shard_compare(torch, sc, shard_cases)
    b9_worst = phase_stoch_shard_chunk_compare(torch, sc, shard_cases)
    clock("phases 18-19 (B5, B6, B8, B9 against their plain versions)")
    mesh_launches = phase_mesh_main(torch, fa7, fa7_2, c7, specs[6][1], card)
    phase_nccl_world_of_one(torch, fa7)
    clock("phase 20 (the meshes)")
    shard_times = phase_shard_timing(torch, ss, sch, sc, fa7, card)
    if "jax" in sys.modules:
        fail("jax was imported")
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    kernel_ms, plain_ms = times[("hard.cnf B=16384", "fixed")]
    b3_ms, b3_plain = stoch_times[("hard.cnf B=16384", "fused")]
    b4_ms, b4_plain = stoch_times[("n1k B=8192", "stream")]
    b2_ms, b2_plain = b2_times[(big[0][0], "fixed")]

    def row(name, source, replaces, n, err, ms, plain, bound_ms_by):
        # no single PyTorch call computes any of these functions: no library time
        return {"name": name, "route": "cuda", "source": f"odesat_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1],
                "library_ms": None}

    b5_ms, b5_plain, b5_bound, b5_by = shard_times["fixed"]
    b8_ms, b8_plain, b8_bound, b8_by = shard_times["b8"]
    b6_ms, b6_plain, b6_bound, b6_by = shard_times["b6"]
    b9_ms, b9_plain, b9_bound, b9_by = shard_times["b9"]
    say(json.dumps({"kernels": [
        row("fused_chunk", "fused_chunk.cu", "odesat_tpu/ops/fused_pallas.py:66", launches,
            worst, kernel_ms, plain_ms, ode_chunk_bound(hard, 16384, 256, True)),
        row("stoch_fused", "stoch_chunk.cu", "odesat_tpu/ops/stoch_pallas.py:75",
            stoch_launches["stoch_fused"], stoch_worst["fused"], b3_ms, b3_plain,
            stoch_chunk_bound(hard, 16384, 64)),
        row("stoch_stream", "stoch_chunk.cu", "odesat_tpu/ops/stoch_pallas.py:345",
            stoch_launches["stoch_stream"], stoch_worst["stream"], b4_ms, b4_plain,
            stoch_chunk_bound(n1k, 8192, 8)),
        row("stream_chunk", "stream_chunk.cu", "odesat_tpu/ops/stream_pallas.py:166",
            b2_launches, b2_worst, b2_ms, b2_plain, ode_chunk_bound(big[0][1], big[0][2], 8, True)),
        row("rhs", "stream_chunk.cu", "odesat_tpu/ops/rhs_pallas.py:62", b10_launches,
            b10_worst, b10_ms, b10_plain, rhs_pass_bound(hard, 16384)),
        row("shard_stream", "stream_chunk.cu", "odesat_tpu/ops/shard_stream.py:574",
            mesh_launches["shard_stream"], b5_worst, b5_ms, b5_plain, (b5_bound, b5_by)),
        row("shard_chunk", "stream_chunk.cu", "odesat_tpu/ops/shard_chunk.py:158",
            mesh_launches["shard_chunk"], b6_worst, b6_ms, b6_plain, (b6_bound, b6_by)),
        row("stoch_shard_eval", "stoch_chunk.cu", "odesat_tpu/ops/stoch_pallas.py:605",
            mesh_launches["stoch_shard_eval"], b8_worst, b8_ms, b8_plain, (b8_bound, b8_by)),
        row("stoch_shard_chunk", "stoch_chunk.cu", "odesat_tpu/ops/stoch_pallas.py:868",
            mesh_launches["stoch_shard_chunk"], b9_worst, b9_ms, b9_plain, (b9_bound, b9_by)),
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
