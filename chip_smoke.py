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
2. build: nvcc of csrc/fused_chunk.cu, csrc/stoch_chunk.cu and
   csrc/stream_chunk.cu and g++ of the native preprocessor, all started
   together; seconds, ptxas's
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
17. B10 timing: one RHS pass, B10 and the twin in turns, hard.cnf B=16384.

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
    card = phase_device(torch)
    phase_build(fc, sc, stc)
    cases, hard, uf250 = load_cases()
    worst = phase_compare(torch, fc, cases)
    worst = max(worst, phase_compare_finishing(torch, fc, uf250))
    say(f"[compare] all cases within tolerance; max abs err {worst:.6e}")
    phase_determinism(torch, fc, hard, uf250)
    launches = phase_main_sat(fc)
    launches += phase_main_unsat(fc, card)
    times = phase_timing(torch, fc, hard, uf250, card)

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
    if "jax" in sys.modules:
        fail("jax was imported")
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    kernel_ms, plain_ms = times[("hard.cnf B=16384", "fixed")]
    b3_ms, b3_plain = stoch_times[("hard.cnf B=16384", "fused")]
    b4_ms, b4_plain = stoch_times[("n1k B=8192", "stream")]
    b2_ms, b2_plain = b2_times[(big[0][0], "fixed")]

    def row(name, source, replaces, n, err, ms, plain):
        return {"name": name, "route": "cuda", "source": f"odesat_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain}

    say(json.dumps({"kernels": [
        row("fused_chunk", "fused_chunk.cu", "odesat_tpu/ops/fused_pallas.py:66", launches,
            worst, kernel_ms, plain_ms),
        row("stoch_fused", "stoch_chunk.cu", "odesat_tpu/ops/stoch_pallas.py:75",
            stoch_launches["stoch_fused"], stoch_worst["fused"], b3_ms, b3_plain),
        row("stoch_stream", "stoch_chunk.cu", "odesat_tpu/ops/stoch_pallas.py:345",
            stoch_launches["stoch_stream"], stoch_worst["stream"], b4_ms, b4_plain),
        row("stream_chunk", "stream_chunk.cu", "odesat_tpu/ops/stream_pallas.py:166",
            b2_launches, b2_worst, b2_ms, b2_plain),
        row("rhs", "stream_chunk.cu", "odesat_tpu/ops/rhs_pallas.py:62", b10_launches,
            b10_worst, b10_ms, b10_plain),
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
