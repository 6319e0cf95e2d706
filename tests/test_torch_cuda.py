"""The CUDA chunk kernel against its plain torch version, on the card.

These tests need an NVIDIA Hopper GPU and nvcc (the kernel has no CPU
mode) and skip without a CUDA device. The file imports no jax, so it runs
on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the chunk kernels B1 and B2 equal their plain version exactly
(they run its arithmetic in its order, built with --fmad=false); the torch
twin on the card against the CPU to rtol 1e-4 / atol 1e-5 (other sum
orders); B10 equals its plain version (the kernel-order RHS) exactly and the
twin to float32 rtol 2e-4 / atol 2e-5 (tests/test_fused.py's), float64
1e-12; repeats bit-identical; a resumed run (B1, B2, B3, B4, the hybrid,
B6 and B9 at S=2) equals the uninterrupted one bit for bit, and solve_exact
through B1 (its one-dispatch path) its single-step replay exactly; B7 at S=2
and S=4 ranks on the card equals its plain version bit for bit (a NaN equal
to any NaN); the device loop (one graph launch a dispatch) equals the host
loop over the same kernels bit for bit, steps included; the stoch twin's
captured chunk equals its steps and draws launched from Python bit for
bit, the device generator's state included; the clause mesh's captured
chunks (B5, B8, the twins; their B7 calls rebased in the graphs) equal
the same steps launched from Python bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu_torch.cnf import CNFFormula, compile_formula, normalize_cnf_variables  # noqa: E402
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.interop import state_from_numpy  # noqa: E402
from odesat_tpu_torch.models.ode import simulate_batch  # noqa: E402
from odesat_tpu_torch.ops import fused_chunk as fc  # noqa: E402
from odesat_tpu_torch.models.loop import copy_state  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
from odesat_tpu_torch.utils.generate import random_ksat  # noqa: E402

# self-contained (no tests.* imports): another installed package named
# `tests` can shadow this directory on a machine that lacks jax
F32 = dict(rtol=2e-4, atol=2e-5)


def _state(fa, B, seed, device):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, size=(B, fa.n_vars_padded)).astype(np.float32)
    xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
    return state_from_numpy(v, xs, np.ones_like(xs), np.full(B, 0.01, np.float32),
                            np.zeros(B, bool), device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunk kernel has no CPU mode")
    return torch.device("cuda")


def _formula(seed=0, widths=(3,)):
    clauses = [c for k in widths for c in random_ksat(30, 80, k=k, seed=seed + k).clauses]
    return normalize_cnf_variables(CNFFormula(clauses, 30))[1]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("widths", [(3,), (2, 4)])
def test_kernel_matches_plain(cuda, mode, rigidity, widths):
    fa = compile_formula(_formula(widths=widths))
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None, rigidity=rigidity)
    fn = fc.make_fused_chunk(fa, 0.05, ode, 32, cuda)
    state = _state(fa, 37, 0, cuda)
    before = fc.launches
    out = fn(copy_state(state))  # a call consumes its input
    again = fn(copy_state(state))
    ref = fc.fused_chunk_plain(state, fn.spec, 32)
    torch.cuda.synchronize()
    assert fc.launches == before + 2
    for a, b, c in zip(out, ref, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_kernel_matches_plain_as_trajectories_finish(cuda, mode):
    """From a partly solved batch, chunks in which rows finish: the done
    latch, the fixed update-then-freeze and the adaptive no-advance branch
    agree with the plain version, and rows done before a chunk stay put."""
    formula = normalize_cnf_variables(random_ksat(50, 200, seed=3, planted=True))[1]
    fa = compile_formula(formula)
    fn = fc.make_fused_chunk(fa, 0.05, ODEConfig(step_size=0.05 if mode == "fixed" else None),
                             8, cuda)
    state, seen = _state(fa, 64, 2, cuda), False
    for _ in range(2000):
        out = fn(copy_state(state))
        ref = fc.fused_chunk_plain(state, fn.spec, 8)
        for name in ("v", "xs", "xl", "dt"):
            assert torch.equal(getattr(out, name), getattr(ref, name))
            assert torch.equal(getattr(out, name)[state.done], getattr(state, name)[state.done])
        assert torch.equal(out.done, ref.done)
        before, after = int(state.done.sum()), int(out.done.sum())
        state = out
        if 0 < before < after < 64:
            seen = True
            break
    assert seen, "no chunk had rows done before it, rows finishing in it and rows running"


@pytest.mark.cuda
def test_smem_gate_matches_the_kernel(cuda):
    lib, _ = fc.load_library()
    fa = compile_formula(_formula())
    nnz = int((fa.lit_mask > 0).sum())
    K, Mp = fa.lit_var.shape
    for fixed in (True, False):
        for R in (1, 2, fc.fused_lanes(fa, fixed)):
            want = lib.fused_chunk_smem_bytes(fa.n_vars_padded, Mp, K, nnz, int(fixed), R)
            assert fc.fused_smem_bytes(fa, fixed, R) == want


def _chunk_kernels(fa, ode, steps, device):
    """B1 (where its gate takes the formula) and B2 on one formula."""
    from odesat_tpu_torch.ops import stream_chunk as sc

    fixed = ode.step_size is not None
    kernels = [sc.make_stream_chunk(fa, 0.05, ode, steps, device)]
    if fc.fused_supported(fa, fixed):
        kernels.append(fc.make_fused_chunk(fa, 0.05, ode, steps, device))
    return kernels


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 33, 1000])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_chunk_kernels_equal_plain_at_ragged_batches(cuda, B, mode, matmul_dtype):
    """A batch that leaves the last tile of lanes ragged: B1 and B2 equal
    their plain version exactly, and each other."""
    fa = compile_formula(_formula(widths=(2, 4)), bucket=True, min_bucket=32)
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None, matmul_dtype=matmul_dtype)
    state = _state(fa, B, B, cuda)
    kernels = _chunk_kernels(fa, ode, 24, cuda)
    assert len(kernels) == 2
    ref = fc.fused_chunk_plain(state, kernels[0].spec, 24)
    outs = [fn(copy_state(state)) for fn in kernels]
    torch.cuda.synchronize()
    for out in outs:
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_adaptive_lanes_of_one_tile_advance_finish_and_sit_done(cuda):
    """One tile of lanes in which, within one adaptive chunk, some lanes sit
    done from the start, some finish and the rest still run: each lane's
    dt, error and done are its own, and a lane that does not advance keeps
    its state bit for bit."""
    formula = normalize_cnf_variables(random_ksat(50, 200, seed=3, planted=True))[1]
    fa = compile_formula(formula)
    B = 24  # one ragged tile at any R up to 32
    for fn in _chunk_kernels(fa, ODEConfig(), 8, cuda):
        state, seen = _state(fa, B, 4, cuda), False
        done = state.done.clone()
        done[:5] = True
        state = state._replace(done=done)
        for _ in range(2000):
            out = fn(copy_state(state))
            ref = fc.fused_chunk_plain(state, fn.spec, 8)
            for a, b in zip(out, ref):
                assert torch.equal(a, b)
            for name in ("v", "xs", "xl", "dt"):
                assert torch.equal(getattr(out, name)[state.done], getattr(state, name)[state.done])
            before, after = int(state.done.sum()), int(out.done.sum())
            state = out
            if before < after < B:
                seen = True
                break
        assert seen, "no chunk had lanes finishing beside done and running lanes"


@pytest.mark.cuda
def test_simulate_batch_goes_through_the_kernel(cuda):
    formula = normalize_cnf_variables(random_ksat(50, 200, seed=3, planted=True))[1]
    before = fc.launches
    config = SolverConfig(ode=ODEConfig(step_size=0.05, steps=4000), batch_size=64, seed=0)
    result = simulate_batch(formula, config, device=cuda)
    assert fc.launches > before
    assert result.any_solved


@pytest.mark.cuda
@pytest.mark.parametrize("dv_strategy", ["gather", "segment_sum"])
def test_twin_on_cuda_matches_the_cpu(cuda, dv_strategy):
    """Unit clauses keep a formula off the kernel; the torch twin then runs
    on the card. Same state, 20 fixed steps, CUDA vs CPU (the sums run in
    other orders, hence the f32 tolerance)."""
    formula = _formula(widths=(1, 3))
    fa = compile_formula(formula)
    ode = ODEConfig(step_size=0.02, dv_strategy=dv_strategy)
    assert tode.resolve_strategy(fa, ODEConfig(step_size=0.02), cuda) != "fused"
    step = tode.make_step_fn(fa, 0.01, ode)
    outs = []
    for device in ("cpu", cuda):
        state, dev = _state(fa, 16, 1, device), tode.formula_device(fa, device)
        for _ in range(20):
            state = step(state, dev)
        outs.append(state)
    for name in ("v", "xs", "xl"):
        torch.testing.assert_close(getattr(outs[1], name).cpu(), getattr(outs[0], name),
                                   rtol=1e-4, atol=1e-5)
    assert torch.equal(outs[1].done.cpu(), outs[0].done)


# ------------------------------------------------ stoch kernels B3 and B4


def _tile_kinds(was, now, R):
    """Whether some tile of R lanes holds chains done before a chunk, chains
    that finish in it and chains that keep running."""
    for t in range(0, was.numel(), R):
        a, b = was[t:t + R], now[t:t + R]
        if a.any() and (b & ~a).any() and not b.all():
            return True
    return False


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 8])
@pytest.mark.parametrize("kernel", ["fused", "stream"])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_stoch_kernel_matches_plain_as_chains_finish(cuda, kernel, matmul_dtype, lanes):
    """From the all-false start on a small planted formula, 8-step chunks
    until one has a tile of lanes (the most that fit, or 8) holding chains
    done before it, chains finishing in it and chains running: kernel and
    plain version agree exactly, done chains stay put bit for bit, and a
    repeat is bit-identical."""
    from odesat_tpu_torch.models.stoch import init_stoch_state
    from odesat_tpu_torch.ops import stoch_chunk as sc

    fa = compile_formula(normalize_cnf_variables(random_ksat(40, 140, seed=3, planted=True))[1])
    fn = sc.make_stoch_chunk(fa, 8, kernel, matmul_dtype, cuda)
    launch = sc.stoch_fused_cuda if kernel == "fused" else sc.stoch_stream_cuda
    B, bf16, seen = 200, matmul_dtype == "bfloat16", False
    R = lanes or (fn.spec.fused_lanes if kernel == "fused" else fn.spec.stream_lanes)
    assert R == lanes or R == 32
    state = init_stoch_state(fa, B, cuda)
    counter = "fused_launches" if kernel == "fused" else "stream_launches"
    for seed in range(1, 500):
        before_launches = getattr(sc, counter)
        out = launch(copy_state(state), fn.spec, 8, seed, bf16, lanes=R)
        again = launch(copy_state(state), fn.spec, 8, seed, bf16, lanes=R)
        ref = sc.stoch_chunk_plain(state, fn.spec, 8, seed, sc.traj_block(B), bf16)
        torch.cuda.synchronize()
        assert getattr(sc, counter) == before_launches + 2
        for a, b, c in zip(out, ref, again):
            assert torch.equal(a, b) and torch.equal(a, c)
        was = state.done
        assert torch.equal(out.v[was], state.v[was]) and torch.equal(out.xl[was], state.xl[was])
        state, found = out, _tile_kinds(was, out.done, R)
        if found:
            seen = True
            break
    assert seen, "no chunk had a tile with chains done before it, finishing in it and running"


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 33, 1000])
@pytest.mark.parametrize("widths", [(3,), (1, 2, 5)])
def test_stoch_b3_equals_b4_and_the_gates_match_the_kernel(cuda, widths, B):
    """At batches that leave the last tile ragged (and B = 1000, two PRNG
    blocks of 512), B3 and B4 equal the plain version exactly at every R
    from 1 to the most that fit, a row done before the chunk stays put,
    B3 equals B4, and the C footprints equal the Python ones at each R."""
    from odesat_tpu_torch.interop import stoch_state_from_numpy
    from odesat_tpu_torch.ops import stoch_chunk as sc

    fa = compile_formula(_formula(widths=widths), bucket=True, min_bucket=32)
    lib, _ = sc.load_library()
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, int((fa.lit_mask > 0).sum())
    rng = np.random.default_rng(B)
    done = np.zeros(B, bool)
    done[B // 2] = B > 1
    state = stoch_state_from_numpy(rng.random((B, Np)) < 0.5, rng.integers(1, 3000, (B, Mp)),
                                   done, cuda)
    spec = sc.stoch_spec(fa, cuda)
    assert spec.fused_lanes == spec.stream_lanes == 32
    ref = sc.stoch_chunk_plain(state, spec, 16, 77, sc.traj_block(B), False)
    assert (ref.v != state.v).any()
    outs = []
    for R in (1, 2, 4, 8, 16, 32):
        assert lib.stoch_fused_smem_bytes(Np, Mp, K, nnz, R) == sc.stoch_fused_smem_bytes(fa, R)
        assert lib.stoch_stream_smem_bytes(Np, Mp, R) == sc.stoch_stream_smem_bytes(fa, R)
        for launch in (sc.stoch_fused_cuda, sc.stoch_stream_cuda):
            outs.append(launch(copy_state(state), spec, 16, 77, False, lanes=R))
    outs += [sc.make_stoch_chunk(fa, 16, k, "float32", cuda)(copy_state(state), 77)
             for k in ("fused", "stream")]
    torch.cuda.synchronize()
    for out in outs:
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    was = state.done
    assert torch.equal(outs[0].v[was], state.v[was]) and torch.equal(outs[0].xl[was], state.xl[was])


@pytest.mark.cuda
def test_stoch_search_goes_through_the_kernel(cuda):
    from odesat_tpu_torch.models.stoch import search
    from odesat_tpu_torch.ops import stoch_chunk as sc

    formula = normalize_cnf_variables(random_ksat(40, 140, seed=3, planted=True))[1]
    before = sc.fused_launches
    config = SolverConfig(ode=ODEConfig(steps=4000), batch_size=64, seed=0)
    result = search(formula, config, device=cuda)
    assert sc.fused_launches > before
    assert result.solved_index is not None


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["small", "easy"])
def test_stoch_cli_verifies_on_the_card(cuda, name, capsys):
    """The stoch main path on the card; small.cnf preprocesses to no
    clause at all, so B3 runs a formula of padding only."""
    import os

    from odesat_tpu_torch import cli

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", f"{name}.cnf")
    assert cli.main(["stoch", "-f", path, "-b", "256", "-n", "20000", "--seed", "2"]) == 0
    assert "Checking if solution vector satisfies formula: true" in capsys.readouterr().out


# ------------------------------------ B2 (large-formula chunk) and B10 (RHS)


def _past_b1(seed=11, m=8000):
    """Planted random 3-SAT n=2000: Mp=8064, past B1's gate in both
    integrators, inside B2's."""
    return normalize_cnf_variables(random_ksat(2000, m, k=3, seed=seed, planted=True))[1]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths", [(3,), (2, 4)])
def test_stream_kernel_equals_plain_and_b1(cuda, mode, rigidity, matmul_dtype, widths):
    """B2 computes exactly what B1 computes: bit for bit its plain version
    (B1's) and B1 itself, and a repeat is bit-identical."""
    from odesat_tpu_torch.ops import stream_chunk as sc

    fa = compile_formula(_formula(widths=widths), bucket=True, min_bucket=32)
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None, rigidity=rigidity,
                    matmul_dtype=matmul_dtype)
    fn = sc.make_stream_chunk(fa, 0.05, ode, 32, cuda)
    state = _state(fa, 37, 0, cuda)
    before = sc.launches
    out, again = fn(copy_state(state)), fn(copy_state(state))
    ref = sc.stream_chunk_plain(state, fn.spec, 32)
    b1 = fc.make_fused_chunk(fa, 0.05, ode, 32, cuda)(state)
    torch.cuda.synchronize()
    assert sc.launches == before + 2
    for a, b, c, d in zip(out, again, ref, b1):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_stream_kernel_matches_plain_as_trajectories_finish(cuda, mode):
    from odesat_tpu_torch.ops import stream_chunk as sc

    formula = normalize_cnf_variables(random_ksat(50, 200, seed=3, planted=True))[1]
    fa = compile_formula(formula)
    fn = sc.make_stream_chunk(fa, 0.05, ODEConfig(step_size=0.05 if mode == "fixed" else None),
                              8, cuda)
    state, seen = _state(fa, 64, 2, cuda), False
    for _ in range(2000):
        out = fn(copy_state(state))
        ref = sc.stream_chunk_plain(state, fn.spec, 8)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        for name in ("v", "xs", "xl", "dt"):
            assert torch.equal(getattr(out, name)[state.done], getattr(state, name)[state.done])
        before, after = int(state.done.sum()), int(out.done.sum())
        state = out
        if 0 < before < after < 64:
            seen = True
            break
    assert seen, "no chunk had rows done before it, rows finishing in it and rows running"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_stream_gate_matches_the_kernel(cuda, mode):
    """The gate's shared-memory limit and footprints are the card's, and
    the kernel runs a v window that takes fewer lanes than 32: the
    locally-structured n=4096 instance (Np=4096), 8 lanes fixed, 4
    adaptive."""
    from odesat_tpu_torch.ops import stream_chunk as sc
    from odesat_tpu_torch.utils.generate import random_local_ksat

    lib, _ = sc.load_library()
    assert lib.stream_chunk_smem_limit() == sc.SMEM_LIMIT_BYTES
    fa = compile_formula(normalize_cnf_variables(
        random_local_ksat(4096, 17203, k=3, locality=256, seed=3))[1], window_sort=True)
    fixed = mode == "fixed"
    assert sc.stream_supported(fa, fixed) and not fc.fused_supported(fa, fixed)
    fn = sc.make_stream_chunk(fa, 0.01, ODEConfig(step_size=0.01 if fixed else None), 4, cuda)
    R = fn.spec.lanes
    assert R == (8 if fixed else 4)
    assert lib.stream_chunk_smem_bytes(fa.n_vars_padded, int(fixed), R) == \
        sc.stream_smem_bytes(fa.n_vars_padded, fixed, R) <= sc.SMEM_LIMIT_BYTES
    nnz = int((fa.lit_mask > 0).sum())
    assert lib.stream_chunk_scratch_floats(fa.n_vars_padded, fa.n_clauses_padded, nnz,
                                           int(fixed), R) == \
        sc.stream_scratch_floats(fa.n_vars_padded, fa.n_clauses_padded, nnz, fixed, R)
    state = _state(fa, 13, 5, cuda)
    out, ref = fn(copy_state(state)), sc.stream_chunk_plain(state, fn.spec, 4)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_simulate_batch_and_solve_go_through_b2(cuda, capsys, tmp_path):
    from odesat_tpu_torch import cli
    from odesat_tpu_torch.cnf import cnf_to_dimacs
    from odesat_tpu_torch.ops import stream_chunk as sc

    formula = _past_b1()
    assert tode.resolve_strategy(compile_formula(formula), ODEConfig(step_size=0.01),
                                 cuda) == "stream"
    before = sc.launches
    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=20000), batch_size=256, seed=0)
    result = simulate_batch(formula, config, device=cuda)
    assert sc.launches > before and result.any_solved

    path = tmp_path / "planted_n2000_m7000.cnf"
    path.write_text(cnf_to_dimacs(random_ksat(2000, 7000, k=3, seed=11, planted=True)))
    before = sc.launches
    assert cli.main(["solve", "-f", str(path), "-s", "0.01", "-n", "20000", "--seed", "0"]) == 0
    assert sc.launches > before
    assert "Checking if solution vector satisfies formula: true" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 33, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("bucket", [False, True])
def test_rhs_kernel_matches_the_twin(cuda, B, dtype, rigidity, bucket):
    """B10 against its plain version (the kernel-order RHS) bit for bit, at
    every R from 1 to the most that fit in the wrapper's form and in the
    streamed form forced into windows of 32 clauses at small R; then the
    wrapper's own launch against the plain version and the twin's gather
    RHS: f32 to rtol 2e-4 / atol 2e-5, f64 to 1e-12 (the twin sums in
    another order)."""
    from odesat_tpu_torch.ops import rhs_kernel as rk

    fa = compile_formula(_formula(widths=(2, 3, 5)), bucket=bucket, min_bucket=32)
    rng = np.random.default_rng(4)
    v = torch.as_tensor(rng.uniform(-1, 1, (B, fa.n_vars_padded)), dtype=dtype, device=cuda)
    xs = torch.as_tensor(rng.uniform(0.001, 0.999, (B, fa.n_clauses_padded)), dtype=dtype,
                         device=cuda)
    xl = torch.as_tensor(rng.uniform(1, 50, (B, fa.n_clauses_padded)), dtype=dtype, device=cuda)
    name = "float64" if dtype == torch.float64 else "float32"
    spec = rk.rhs_spec(fa, 0.05, rigidity, cuda)
    plain = rk.rhs_plain(v, xs, xl, spec)
    itemsize = 8 if dtype == torch.float64 else 4
    best = rk.rhs_plan(spec.Np, spec.Mp, spec.nnz, itemsize)
    # every R the wrapper's form takes, and the streamed form in windows of 32
    plans = [(R, best.resident, None)
             for R in rk.rhs_lane_range(spec.Np, spec.Mp, spec.nnz, itemsize, best.resident)]
    plans += [(R, False, 32) for R in (1, 2)]
    lib, _ = rk.load_library()
    for R, resident, window in plans:
        plan = rk.rhs_plan(spec.Np, spec.Mp, spec.nnz, itemsize, R, resident, window)
        assert lib.rhs_smem_bytes(int(itemsize == 8), int(plan.resident), spec.Np, plan.window,
                                  spec.nnz, R) == plan.smem_bytes
        before = rk.launches
        out = rk.rhs_cuda(v, xs, xl, spec, plan)
        torch.cuda.synchronize()
        assert rk.launches == before + 1
        for a, b in zip(out, plain):
            assert torch.equal(a, b), (R, resident, window)
    fn = rk.make_rhs_kernel(fa, 0.05, rigidity, name)
    dev = tode.formula_device(fa, cuda, dtype)
    out = fn(v, xs, xl, dev)
    buckets = fa.bucket_slices if len(fa.bucket_slices) > 1 else None
    ref = rk.rhs_twin(v, xs, xl, dev, 0.05, rigidity, buckets)
    torch.cuda.synchronize()
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    tol = F32 if dtype == torch.float32 else dict(rtol=1e-12, atol=1e-12)
    for a, b in zip(out[:3], ref[:3]):
        torch.testing.assert_close(a, b, **tol)
    assert torch.equal(out[3], ref[3])


@pytest.mark.cuda
def test_rhs_launch_past_the_gate_raises(cuda):
    """Plans the kernel does not take (more shared memory than a CTA may
    use, more lanes or threads than it is built for, a resident window
    short of Mp) are refused at launch and launch nothing; past the gate
    the wrapper refuses the formula instead of running the twin."""
    from dataclasses import replace
    from types import SimpleNamespace

    from odesat_tpu_torch.ops import rhs_kernel as rk

    fa = compile_formula(normalize_cnf_variables(random_ksat(2000, 8000, k=3, seed=11))[1])
    spec = rk.rhs_spec(fa, 0.05, "paper", cuda)
    v = torch.zeros((4, fa.n_vars_padded), device=cuda)
    xs = torch.full((4, fa.n_clauses_padded), 0.5, device=cuda)
    xl = torch.ones_like(xs)
    plan = rk.launch_plan(spec, 4, torch.float32)
    too_big = rk.RhsPlan(2, True, spec.Mp, rk.rhs_smem_bytes(spec.Np, spec.Mp, spec.nnz, 4, 2,
                                                               True), 512)
    assert too_big.smem_bytes > rk.SMEM_LIMIT_BYTES
    before = rk.launches
    for bad in (too_big, replace(plan, lanes=16), replace(plan, threads=2048),
                rk.RhsPlan(1, True, 64, rk.rhs_smem_bytes(spec.Np, 64, spec.nnz, 4, 1, True),
                           256)):
        with pytest.raises(RuntimeError, match="launch failed"):
            rk.rhs_cuda(v, xs, xl, spec, bad)
    assert rk.launches == before
    wide = SimpleNamespace(min_width=3, n_vars_padded=58112, n_clauses_padded=128,
                           lit_mask=np.ones((3, 128), np.int8))
    with pytest.raises(ValueError, match="shared memory"):
        rk.make_rhs_kernel(wide, 0.05)


# ------------- clause shards: B5 (shard RHS), B8 (stoch eval), B6 and B9 (chunks)


def _sharded(n_shards, widths=(2, 3, 5), seed=0):
    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded

    return compile_stream_sharded(_formula(seed=seed, widths=widths), n_shards, min_bucket=32)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 33, 37])
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("mode", ["rhs", "fixed", "second"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_shard_kernel_equals_plain(cuda, B, n_shards, mode, rigidity, matmul_dtype):
    """B5 in each mode equals its plain version bit for bit on every shard,
    through the row-major wrapper (tile, launch, untile) and the tiled
    entry at a ragged last tile, the launch counter moves once a launch,
    and a repeat is identical."""
    from odesat_tpu_torch.ops import shard_stream as ss
    from odesat_tpu_torch.ops.tiles import tile

    fa = _sharded(n_shards)
    ode = ODEConfig(step_size=0.02, rigidity=rigidity, matmul_dtype=matmul_dtype)
    rng = np.random.default_rng(3 + B)
    ml = fa.shard_plan.mp_local

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(cuda, dtype)

    v = put(rng.uniform(-1, 1, (B, fa.n_vars_padded)))
    for s in range(n_shards):
        spec = ss.shard_spec(fa, 0.05, ode, cuda, s)
        rows = dict(v=v, xs=put(rng.uniform(0.001, 0.999, (B, ml))),
                    xl=put(rng.uniform(1, 50, (B, ml))), dt=put(rng.uniform(0, 0.05, B)),
                    adv=put(rng.random(B) < 0.7, torch.bool),
                    dxs1=put(rng.uniform(-1, 1, (B, ml))), dxl1=put(rng.uniform(-1, 1, (B, ml))))
        keys = {"rhs": ("v", "xs", "xl"), "fixed": ("v", "dt", "xs", "xl"),
                "second": ("v", "dt", "adv", "xs", "xl", "dxs1", "dxl1")}[mode]
        plain = {"rhs": ss.shard_rhs_plain, "fixed": ss.shard_fixed_plain,
                 "second": ss.shard_second_plain}[mode]
        launch = {"rhs": ss.shard_rhs, "fixed": ss.shard_fixed, "second": ss.shard_second}[mode]
        ref = plain(*(rows[k] for k in keys), spec)
        before = ss.launches
        outs = [launch(*(rows[k] for k in keys), spec) for _ in range(2)]
        tiled = {k: tile(rows[k], fill=True if k == "adv" else 0.5) for k in keys}
        t_ref = ss.shard_stream_plain_tiled(mode, spec, **tiled)
        scratch = ss.ShardScratch(spec, tiled["v"].shape[0])
        t_out = ss.shard_stream_cuda(mode, spec, **tiled, scratch=scratch)
        torch.cuda.synchronize()
        assert ss.launches == before + 3
        for a, b, c in zip(outs[0], outs[1], ref):
            assert torch.equal(a, c) and torch.equal(a, b)
        for a, c in zip(t_out, t_ref):
            assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_single_device_runner_goes_through_b5(cuda, mode):
    from odesat_tpu_torch.ops import shard_stream as ss

    fa = _sharded(1, widths=(3,))
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None)
    state = _state(fa, 16, 1, cuda)
    host = type(state)(*(t.cpu() for t in state))  # the runner consumes its input
    before = ss.launches
    out = ss.make_single_device_runner(fa, 0.05, ode, 8, cuda)(state)
    torch.cuda.synchronize()
    assert ss.launches == before + (8 if mode == "fixed" else 16)
    ref = ss.make_single_device_runner(fa, 0.05, ode, 8, "cpu")(host)
    for name in ("v", "xs", "xl", "dt"):
        torch.testing.assert_close(getattr(out, name).cpu(), getattr(ref, name), **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 33, 300])
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_stoch_shard_kernel_equals_plain(cuda, B, n_shards, matmul_dtype):
    """B8 equals its plain version exactly on every shard (unit clauses
    among them), through the row-major wrapper and the tiled entry at a
    ragged last tile; a repeat is identical."""
    from odesat_tpu_torch.ops import stoch_chunk as sc
    from odesat_tpu_torch.ops.tiles import tile

    fa = _sharded(n_shards, widths=(1, 2, 5))
    rng = np.random.default_rng(5 + B)
    ml = fa.shard_plan.mp_local
    v = torch.as_tensor(rng.random((B, fa.n_vars_padded)) < 0.5, device=cuda)
    active = torch.as_tensor(rng.random(B) < 0.8, device=cuda)
    for s in range(n_shards):
        xl = torch.as_tensor(rng.integers(1, 3001, (B, ml)).astype(np.int32), device=cuda)
        ev = sc.make_stoch_shard_eval(fa, cuda, s, matmul_dtype)
        bf16 = matmul_dtype == "bfloat16"
        before = sc.shard_launches
        outs = [ev(v, xl, active) for _ in range(2)]
        ref = sc.stoch_shard_eval_plain(v, xl, active, ev.spec, bf16)
        tiled = (tile(v), tile(xl, fill=1), tile(~active, fill=True))
        t_ref = sc.stoch_shard_eval_plain_tiled(*tiled, ev.spec, bf16)
        t_out = ev.tiled(*(t.clone() for t in tiled))
        torch.cuda.synchronize()
        assert sc.shard_launches == before + 3
        for a, b, c in zip(outs[0], outs[1], ref):
            assert torch.equal(a, c) and torch.equal(a, b)
        for a, c in zip(t_out, t_ref):
            assert torch.equal(a, c)


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card(cuda):
    from odesat_tpu_torch.parallel import launch

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        launch.spawn(launch.probe, 1, n + 1, "nccl", "cuda", timeout_s=60)


def _chunk_buffers(fa, B, fixed, seed, device, shard=0):
    """Random B6 buffers for one shard: a state with some rows done and a
    reduced acc whose sat count is 0 on some rows (adaptive: acc2 with the
    error in its last column)."""
    from odesat_tpu_torch.ops.shard_chunk import ChunkBuffers

    rng = np.random.default_rng(seed)
    Np, ml = fa.n_vars_padded, fa.shard_plan.mp_local

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)

    acc = rng.uniform(-2, 2, (B, Np + 1))
    acc[:, Np] = rng.integers(0, 3, B)
    b = ChunkBuffers(put(rng.uniform(-1, 1, (B, Np))), put(rng.uniform(0.001, 0.999, (B, ml))),
                     put(rng.uniform(1, 50, (B, ml))), put(rng.uniform(0.01, 0.05, B)),
                     put(rng.random(B) < 0.2, torch.bool), put(acc))
    if not fixed:
        acc2 = rng.uniform(-2, 2, (B, Np + 1))
        acc2[:, Np] = rng.uniform(0, 1e-2, B)
        b = b._replace(acc2=put(acc2), dxs1=put(rng.uniform(-1, 1, (B, ml))),
                       dxl1=put(rng.uniform(-1, 1, (B, ml))))
    return b


def _partials(b, S, seed):
    """S partials (rank order) of a launch's acc and acc2, as a clause mesh
    of S ranks gives them to the next launch (None at S = 1: the launch
    reads its own acc, acc2): magnitudes on which rank order and tree order
    round differently, each rank's sat count 0 or 1 (the sum 0 on some
    rows), each rank's error non-negative."""
    if S == 1:
        return None
    rng = np.random.default_rng(seed)
    Np = b.acc.shape[1] - 1

    def draw(flag_col):
        out = []
        for _ in range(S):
            a = rng.uniform(-1, 1, b.acc.shape) * 10.0 ** rng.integers(-3, 6, b.acc.shape)
            a[:, Np] = flag_col()
            out.append(torch.as_tensor(a.astype(np.float32), device=b.acc.device))
        return out

    B = b.acc.shape[0]
    p1 = draw(lambda: rng.integers(0, 2, B) * (rng.random(B) < 0.7))
    p2 = None if b.acc2 is None else draw(lambda: rng.uniform(0, 1e-2, B))
    return p1, p2


def _tiled_parts(parts):
    from odesat_tpu_torch.ops.tiles import tile

    return None if parts is None else tuple(None if p is None else [tile(t) for t in p]
                                            for p in parts)


def _tiled(buffers):
    from odesat_tpu_torch.ops.tiles import tile

    return type(buffers)(*(None if t is None else tile(t) for t in buffers))


def _untiled(buffers, B):
    from odesat_tpu_torch.ops.tiles import untile

    return type(buffers)(*(None if t is None else untile(t, B) for t in buffers))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_shard_chunk_kernel_equals_plain(cuda, B, n_shards, mode, rigidity, matmul_dtype, S):
    """B6 in every phase of its integrator, with and without the apply
    prologue, on tiled buffers (a ragged last tile), reading its own
    partials (S = 1, a group of one) or S ranks' partials that its kernels
    add in the butterfly's tree (a clause mesh; S = 3 the run-time group
    size), equals its plain version bit for bit on every shard; the launch
    counter moves once a launch, B7's fused counter once a launch that
    reads S > 1 partials."""
    from odesat_tpu_torch.ops import butterfly as bf
    from odesat_tpu_torch.ops import shard_chunk as sch
    from odesat_tpu_torch.ops import shard_stream as ss

    fa = _sharded(n_shards)
    fixed = mode == "fixed"
    ode = ODEConfig(step_size=0.02 if fixed else None, rigidity=rigidity,
                    matmul_dtype=matmul_dtype)
    phases = ([("step", False), ("step", True), ("apply", False)] if fixed else
              [("first", False), ("first", True), ("half", False), ("commit", False)])
    for s in range(n_shards):
        spec = ss.shard_spec(fa, 0.05, ode, cuda, s)
        for i, (phase, apply) in enumerate(phases):
            b = _chunk_buffers(fa, B, fixed, seed=10 * s + i, device=cuda)
            parts = _partials(b, S, seed=100 + 10 * s + i)
            ref = sch.shard_chunk_plain(phase, b, spec, apply, parts)
            before, fused = sch.launches, bf.fused_launches
            out = _untiled(sch.shard_chunk_cuda(phase, _tiled(b), spec, apply,
                                                parts=_tiled_parts(parts)), B)
            torch.cuda.synchronize()
            assert sch.launches == before + 1
            assert bf.fused_launches == fused + (S > 1)
            for name, a, c in zip(b._fields, out, ref):
                assert (a is None and c is None) or torch.equal(a, c), (phase, apply, name)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 19])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_shard_chunk_runner_equals_b5_runner(cuda, B, mode):
    """The chunk through B6 equals the per-step path through B5 bit for
    bit, with the launch counts of its schedule, at a full and a ragged
    last tile."""
    from odesat_tpu_torch.ops import shard_chunk as sch
    from odesat_tpu_torch.ops import shard_stream as ss

    fa = _sharded(1, widths=(3,))
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None)
    state = _state(fa, B, 1, cuda)
    state = state._replace(done=torch.arange(B, device=cuda) % 5 == 0)
    before = sch.launches
    out = sch.make_shard_chunk(fa, 0.05, ode, 8, None, cuda)(copy_state(state))
    torch.cuda.synchronize()
    assert sch.launches == before + (9 if mode == "fixed" else 17)
    ref = ss.make_single_device_runner(fa, 0.05, ode, 8, cuda)(state)
    for name, a, b in zip(state._fields, out, ref):
        assert torch.equal(a, b), name


def _row_major_clause_loop(fa, ode, state, steps):
    """The ``--shard-chunk off`` ODE step loop as it ran on rows, through
    B5's row-major wrappers (S=1)."""
    from odesat_tpu_torch.ops import shard_stream as ss
    from odesat_tpu_torch.ops.fused_chunk import _clamp

    spec = ss.shard_spec(fa, 0.05, ode, state.v.device)
    v, xs, xl, dt, done = state

    def clamp_v(x):
        return _clamp(x, -1.0, 1.0)

    for _ in range(steps):
        if ode.step_size is not None:
            dt_eff = torch.where(done, 0.0, v.new_tensor(float(ode.step_size)))
            dv, xs, xl, sat = ss.shard_fixed(v, dt_eff, xs, xl, spec)
            v, done = clamp_v(v + dt_eff.unsqueeze(1) * dv), done | sat
            continue
        dv1, dxs1, dxl1, sat = ss.shard_rhs(v, xs, xl, spec)
        advance = ~done & ~sat
        half = 0.5 * dt.unsqueeze(1)
        fv = clamp_v(v + dt.unsqueeze(1) * dv1)
        hv = clamp_v(v + half * dv1)
        dv2, xs, xl, err_sl = ss.shard_second(hv, dt, advance, xs, xl, dxs1, dxl1, spec)
        tv = clamp_v(hv + half * dv2)
        err = torch.maximum(err_sl, (fv - tv).abs().amax(dim=1))
        new_dt = _clamp(dt * torch.sqrt(err.new_tensor(float(ode.tolerance)) /
                                        err.clamp_min(1e-30)), 2.0**-7, 1000.0)
        v = torch.where(advance.unsqueeze(1), tv, v)
        dt, done = torch.where(advance, new_dt, dt), done | sat
    return type(state)(v, xs, xl, dt, done)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_tiled_b5_runner_equals_b6_chunk_and_the_row_major_loop(cuda, B, mode):
    """B5's runner, tiled once a chunk, equals the B6 chunk and the
    row-major step loop it replaced bit for bit, at a ragged last tile."""
    from odesat_tpu_torch.ops import shard_chunk as sch
    from odesat_tpu_torch.ops import shard_stream as ss

    fa = _sharded(1, widths=(3,))
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None)
    state = _state(fa, B, 2, cuda)
    state = state._replace(done=torch.arange(B, device=cuda) % 4 == 1)
    out = ss.make_single_device_runner(fa, 0.05, ode, 8, cuda)(copy_state(state))
    b6 = sch.make_shard_chunk(fa, 0.05, ode, 8, None, cuda)(copy_state(state))
    ref = _row_major_clause_loop(fa, ode, state, 8)
    torch.cuda.synchronize()
    for name, a, b, c in zip(state._fields, out, b6, ref):
        assert torch.equal(a, b) and torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("B", [7, 300])
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_stoch_shard_chunk_kernel_equals_plain(cuda, B, n_shards, matmul_dtype, S):
    """B9 with and without the flip prologue, and the flip-only launch, on
    tiled chains (a ragged last tile), reading its own partials (S = 1) or
    S ranks' partials that its kernels sum in the butterfly's tree (a
    clause mesh), equals its plain version exactly on every shard."""
    from odesat_tpu_torch.ops import stoch_chunk as sc
    from odesat_tpu_torch.ops.tiles import tile, untile

    fa = _sharded(n_shards, widths=(1, 2, 5))
    rng = np.random.default_rng(7)
    ml, Np = fa.shard_plan.mp_local, fa.n_vars_padded
    bf16 = matmul_dtype == "bfloat16"

    def sums():
        acc = rng.integers(0, 40, (B, 2 * Np + 1)).astype(np.float32)
        acc[:, Np:2 * Np] = np.minimum(acc[:, Np:2 * Np], acc[:, :Np])
        acc[:, 2 * Np] = rng.integers(0, 2, B)
        return torch.as_tensor(acc, device=cuda)

    for s in range(n_shards):
        spec = sc.stoch_shard_spec(fa, cuda, s)
        for apply, evaluate in ((False, True), (True, True), (True, False)):
            v = torch.as_tensor(rng.random((B, Np)) < 0.5, device=cuda)
            xl = torch.as_tensor(rng.integers(1, 3001, (B, ml)).astype(np.int32), device=cuda)
            done = torch.as_tensor(rng.random(B) < 0.2, device=cuda)
            acc = sums()
            parts = None if S == 1 else [sums() for _ in range(S)]
            args = (spec, bf16, 12345, sc.traj_block(B), 3, apply, evaluate)
            ref = sc.stoch_shard_step_plain(v, xl, done, acc, *args, parts=parts)
            before = sc.shard_chunk_launches
            out = sc.stoch_shard_step_cuda(*(tile(t) for t in (v, xl, done, acc)), *args,
                                           parts=None if parts is None else
                                           [tile(p) for p in parts])
            torch.cuda.synchronize()
            assert sc.shard_chunk_launches == before + 1
            for a, c in zip(out, ref):
                assert torch.equal(untile(a, B), c), (apply, evaluate)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 45])
@pytest.mark.parametrize("name", ["B6 fixed", "B6 adaptive", "B5", "B9", "B8"])
def test_clause_runners_donate_and_allocate_nothing_on_a_second_chunk(cuda, name, B):
    """Each clause-mesh runner returns its input's storage, equal to a run
    from a copy; its second chunk of the shape, from another state,
    allocates nothing and leaves the first result as it was, and so does
    the first chunk of a runner of another length of the same formula."""
    from odesat_tpu_torch.models.stoch import init_stoch_state
    from odesat_tpu_torch.ops import shard_chunk as sch
    from odesat_tpu_torch.ops import shard_stream as ss
    from odesat_tpu_torch.parallel import sharded

    fa = _sharded(1, widths=(3,))
    if name in ("B9", "B8"):
        def make(steps=6):
            return sharded.make_clause_stoch_runner(fa, steps, cuda,
                                                    torch.Generator().manual_seed(3), None,
                                                    "float32", "auto" if name == "B9" else "off")

        def state_of(seed):
            st = init_stoch_state(fa, B, cuda)
            g = torch.Generator(device=cuda).manual_seed(seed)
            return st._replace(v=torch.rand(st.v.shape, generator=g, device=cuda) < 0.5)
    else:
        ode = ODEConfig(step_size=0.02 if name != "B6 adaptive" else None)
        build = ss.make_single_device_runner if name == "B5" else \
            (lambda *a: sch.make_shard_chunk(*a[:4], None, a[4]))

        def make(steps=6):
            return build(fa, 0.05, ode, steps, cuda)

        def state_of(seed):
            return _state(fa, B, seed, cuda)
    run = make()
    first = state_of(1)
    want = make()(copy_state(first))
    ptrs = [t.data_ptr() for t in first]
    got = run(first)
    assert [t.data_ptr() for t in got] == ptrs
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    kept = copy_state(got)
    second = state_of(2)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    run(second)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before
    for a, b in zip(got, kept):
        assert torch.equal(a, b)
    # a runner of another length (a solve's tail or grown chunk) takes the
    # formula's held buffers: its first call of the shape allocates nothing
    tail, third = make(3), state_of(3)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    tail(third)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 45])
def test_stoch_shard_chunk_runner_equals_b8_path(cuda, B):
    """The stoch clause path through B9 flips as the path through B8 does,
    at a full and a ragged last tile."""
    from odesat_tpu_torch.parallel import sharded

    fa = _sharded(1, widths=(3,))
    a = sharded.run_stoch_clause(None, cuda, fa, 3, 9, 4, "float32", B, "auto")
    b = sharded.run_stoch_clause(None, cuda, fa, 3, 9, 4, "float32", B, "off")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------- B7 over ranks on the card


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 3, 4])
def test_butterfly_kernel_equals_plain_across_ranks_on_one_card(cuda, S):
    """B7 at S ranks sharing the card (gloo carries only the handles and
    the host's checks; S = 3 takes the kernel's run-time group size, and an
    absent partner in the tree): at ragged lengths, with and without a max zone,
    and over 200 back-to-back calls on fresh data, every call's result on
    every rank equals its plain version bit for bit (NaN equal to NaN); a
    call launches the kernel once; a shape that differs between ranks is
    refused."""
    from odesat_tpu_torch.parallel import launch
    from odesat_tpu_torch.parallel.dist import all_reduce_error, butterfly_of

    calls = []
    for shape in ((1,), (7,), (33, 1025)):
        n = int(np.prod(shape))
        calls += [(all_reduce_error, (shape, 1, None, 2)),
                  (all_reduce_error, (shape, 2, (min(n, 7), min(n, 2)), 2))]
    calls.append((all_reduce_error, ((64, 33), 3, (33, 1), 200)))
    parts = [np.full((3, 5), 10.0 ** k, np.float32) for k in range(S)]
    calls.append((butterfly_of, (parts,)))
    values = launch.spawn(launch.run_all, 1, S, "gloo", "cuda", timeout_s=300, args=(calls,))
    assert values[:-1] == [0.0] * (len(calls) - 1)
    out, same = values[-1]
    pairs = [parts[k] + parts[k + 1] if k + 1 < S else parts[k] for k in range(0, S, 2)]
    want = pairs[0] if S == 2 else pairs[0] + pairs[1]  # the tree at S = 2, 3, 4
    assert same and np.array_equal(out, want)
    for report in launch.last_reports:
        assert [c["butterfly"] for c in report["calls"]] == [2] * 6 + [200, 1]
    bad = [np.zeros(7, np.float32)] * (S - 1) + [np.zeros(8, np.float32)]
    with pytest.raises(ValueError, match="shape"):
        launch.spawn(butterfly_of, 1, S, "gloo", "cuda", timeout_s=120, args=(bad,))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 3, 4, 5])
def test_butterfly_tree_alone_equals_plain(cuda, S):
    """B7's kernel alone (tree_cuda, S buffers of one process, the entry the
    split of a call times) equals the plain tree bit for bit, with and
    without a max zone, at ragged lengths (a NaN equal to any NaN)."""
    from odesat_tpu_torch.ops import butterfly as bf
    from odesat_tpu_torch.parallel.dist import bit_error, butterfly_inputs

    for shape, zones in (((7,), None), ((33, 1025), None), ((33, 1025), (1025, 1))):
        parts = list(butterfly_inputs(shape, S, 1, 3, cuda)[0])
        before = bf.launches
        out = bf.tree_cuda([p.contiguous() for p in parts], zones)
        torch.cuda.synchronize()
        assert bf.launches == before + 1
        assert bit_error(out.cpu(), bf.combine_parts([p.cpu() for p in parts], zones)) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 3, 4])
def test_butterfly_f64_kernel_equals_plain_across_ranks_on_one_card(cuda, S):
    """B7's float64 form at S ranks sharing the card, its calls between
    float32 calls on the one counter and ring: at ragged lengths, with and
    without a max zone, and over 200 back-to-back calls on fresh data (NaN,
    signed zeros, infinities of both signs), every call's result on every
    rank equals its plain version bit for bit (NaN equal to NaN); a call
    launches its form once; a dtype that differs between ranks is
    refused."""
    from odesat_tpu_torch.parallel import launch
    from odesat_tpu_torch.parallel.dist import all_reduce_error, butterfly_of

    f64 = torch.float64
    calls = []
    for shape in ((1,), (7,), (33, 1025)):
        n = int(np.prod(shape))
        calls += [(all_reduce_error, (shape, 1, None, 2, f64)),
                  (all_reduce_error, (shape, 2, None, 1)),
                  (all_reduce_error, (shape, 3, (min(n, 7), min(n, 2)), 2, f64))]
    calls.append((all_reduce_error, ((64, 33), 4, (33, 1), 200, f64)))
    values = launch.spawn(launch.run_all, 1, S, "gloo", "cuda", timeout_s=300, args=(calls,))
    assert values == [0.0] * len(calls)
    for report in launch.last_reports:
        assert [c["butterfly_f64"] for c in report["calls"]] == [2, 0, 2] * 3 + [200]
        assert [c["butterfly"] for c in report["calls"]] == [0, 1, 0] * 3 + [0]
    bad = [np.zeros(7, np.float64)] * (S - 1) + [np.zeros(7, np.float32)]
    with pytest.raises(ValueError, match="dtype"):
        launch.spawn(butterfly_of, 1, S, "gloo", "cuda", timeout_s=120, args=(bad, None, None))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 3, 4, 5])
def test_butterfly_f64_tree_alone_equals_plain(cuda, S):
    """B7's float64 kernel alone (tree_cuda) equals the plain tree bit for
    bit, with and without a max zone, at ragged lengths, on partials with
    NaN, signed zeros and infinities (a NaN equal to any NaN)."""
    from odesat_tpu_torch.ops import butterfly as bf
    from odesat_tpu_torch.parallel.dist import bit_error, butterfly_inputs

    for shape, zones in (((7,), None), ((33, 1025), None), ((33, 1025), (1025, 1))):
        parts = list(butterfly_inputs(shape, S, 1, 3, cuda, torch.float64)[0])
        before = bf.launches_f64
        out = bf.tree_cuda([p.contiguous() for p in parts], zones)
        torch.cuda.synchronize()
        assert bf.launches_f64 == before + 1 and out.dtype == torch.float64
        assert bit_error(out.cpu(), bf.combine_parts([p.cpu() for p in parts], zones)) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_twin_mesh_step_on_b7_equals_torch_distributed(cuda, shape):
    """The twin's clause step on the card, float64 fixed, adaptive and with
    a batch-shared adaptive dt (at 2x2 the error max over the clause group,
    then over the trajectory group: both groups' B7 calls every step, in
    one order on every rank): B7's route equals torch.distributed's bit for
    bit (both add a0 + a1 at S = 2), and only B7's route launches B7's
    float64 form."""
    import chip_smoke
    from odesat_tpu_torch.parallel import launch, sharded

    fa = compile_formula(_formula(seed=5), clause_pad=64)
    rng = np.random.default_rng(2)
    B = 8
    v = rng.uniform(-1.0, 1.0, size=(B, fa.n_vars_padded))
    xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float64)
    arrays = (v, xs, np.ones_like(xs), np.full(B, 0.01), np.zeros(B, bool))
    cases = [(fa, 0.05, ODEConfig(dtype="float64", **kw), 12, arrays)
             for kw in (dict(step_size=0.01), dict(tolerance=1e-3),
                        dict(tolerance=1e-3, dt_mode="shared"))]
    calls = [(chip_smoke.with_twin_route, (route, sharded.run_ode_cases, cases))
             for route in ("dist", None)]
    today, b7 = launch.spawn(launch.run_all, *shape, "gloo", "cuda", timeout_s=300,
                             args=(calls,))
    for a, b in zip(today, b7):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8))
    for report in launch.last_reports:
        counts = [c["butterfly_f64"] for c in report["calls"]]
        assert counts[0] == 0 and counts[1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
def test_fused_chunks_equal_plain_across_ranks_on_one_card(cuda, S):
    """B6 (fixed and adaptive) and B9 at S ranks sharing the card, 1000
    steps a chunk with no host sync (every launch reads the peers' slots
    after a stream wait: the race run), equal their plain versions (the
    partials over gloo, the tree on the host) bit for bit on every rank, v
    bit-identical over the ranks; the chunks make no standalone B7 call, and
    every launch after the first of a chunk reads the S slots itself."""
    from odesat_tpu_torch.parallel import launch, sharded

    fa = _sharded(S)
    calls = [(sharded.fused_against_plain, (fa, "ode", True, 1000, 64, 1)),
             (sharded.fused_against_plain, (fa, "ode", False, 500, 64, 2)),
             (sharded.fused_against_plain, (fa, "stoch", True, 1000, 64, 3))]
    values = launch.spawn(launch.run_all, 1, S, "gloo", "cuda", timeout_s=600, args=(calls,))
    assert values == [(0.0, True)] * 3
    for report in launch.last_reports:
        for c, launches in zip(report["calls"], (1001, 1001, 1001)):
            assert c["butterfly"] == 0
            assert c["butterfly_fused"] == launches - 1
        assert report["calls"][0]["shard_chunk"] == 1001
        assert report["calls"][1]["shard_chunk"] == 1001
        assert report["calls"][2]["stoch_shard_chunk"] == 1001


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
def test_off_runners_sum_through_standalone_b7_and_b5_equals_b6(cuda, S):
    """At S ranks sharing the card the ``--shard-chunk off`` runners sum
    through B7's standalone call (one a fixed step, three an adaptive one,
    one a stoch step) and not torch.distributed, so B5 equals B6 bit for bit
    and the B8 path flips as the B9 chunk does; the chunks make no
    standalone call."""
    from odesat_tpu_torch.parallel import launch, sharded

    fa = _sharded(S)
    rng = np.random.default_rng(4)
    B, steps = 64, 12
    xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
    arrays = (rng.uniform(-1, 1, (B, fa.n_vars_padded)).astype(np.float32), xs,
              np.ones_like(xs), np.full(B, 0.01, np.float32), np.zeros(B, bool))
    cases = [(fa, 0.05, ODEConfig(step_size=st, shard_chunk=sc), steps, arrays)
             for sc in ("auto", "off") for st in (0.01, None)]
    calls = [(sharded.run_ode_cases, ([c],)) for c in cases]
    calls += [(sharded.run_stoch_clause, (fa, 2, 6, 5, "float32", B, mode))
              for mode in ("auto", "off")]
    values = launch.spawn(launch.run_all, 1, S, "gloo", "cuda", timeout_s=600, args=(calls,))
    (b6_fixed,), (b6_adaptive,), (b5_fixed,), (b5_adaptive,) = values[:4]
    for a, b in ((b6_fixed, b5_fixed), (b6_adaptive, b5_adaptive)):
        for x, y in zip(a[:5], b[:5]):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(values[4], values[5]):
        np.testing.assert_array_equal(x, y)
    for report in launch.last_reports:
        c = report["calls"]
        assert [k["butterfly"] for k in c] == [0, 0, steps, 3 * steps, 0, 12]
        assert all(k["butterfly_fused"] > 0 for k in (c[0], c[1], c[4]))
        assert c[2]["shard_stream"] == steps and c[5]["stoch_shard_eval"] == 12


@pytest.mark.cuda
@pytest.mark.parametrize("cmd", ["inter", "stoch"])
def test_clause_mesh_resume_through_b6_and_b9_on_the_card(cuda, tmp_path, cmd):
    """hard.cnf B=256 at S=2 on the card, 16-step chunks and a snapshot
    every chunk: stopped at 32 steps and resumed to 64, the run ends in the
    snapshot of the run that never stopped, bit for bit, through B6 (inter)
    or B9 (stoch), whose launches read the peers' slots themselves (B7
    fused, no standalone call), on both ranks."""
    import contextlib
    import io
    import os

    from odesat_tpu_torch import cli
    from odesat_tpu_torch.parallel import launch

    hard = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "hard.cnf")
    extra = ["-s", "0.01"] if cmd == "inter" else ["--no-preprocess"]
    calls = []
    for name, steps, resume in (("whole", 64, None), ("part", 32, None),
                                ("resumed", 64, "part")):
        argv = [cmd, "-f", hard, "-b", "256", "--seed", "0", "--chunk-steps", "16", "-n",
                str(steps), *extra, "--checkpoint", str(tmp_path / f"{name}.npz"),
                "--checkpoint-every", "1", "--clause-shards", "2", "--dist-backend", "gloo"]
        if resume:
            argv += ["--resume", str(tmp_path / f"{resume}.npz")]
        with contextlib.redirect_stdout(io.StringIO()):
            calls.append(cli.mesh_call(argv))
    launch.spawn(launch.run_all, 1, 2, "gloo", "cuda", timeout_s=300, args=(calls,))
    kernel = "shard_chunk" if cmd == "inter" else "stoch_shard_chunk"
    for report in launch.last_reports:  # B7 fused into the launches, no call of its own
        assert all(c[kernel] > 0 and c["butterfly_fused"] > 0 and c["butterfly"] == 0
                   for c in report["calls"])
    whole, resumed = _snapshot(tmp_path / "whole.npz"), _snapshot(tmp_path / "resumed.npz")
    assert sorted(whole) == sorted(resumed) and int(whole["steps"]) == 64
    for key in whole:
        np.testing.assert_array_equal(whole[key], resumed[key], err_msg=key)


# ------------------------------------------- resume, the hybrid, exact TTS


def _snapshot(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _resume_equals_whole(tmp_path, run, budget, part):
    """``run(path, steps, resume)`` with a snapshot every chunk: the run
    that never stopped and the one stopped at ``part`` steps and resumed
    end in the same snapshot, bit for bit."""
    run(str(tmp_path / "whole.npz"), budget, None)
    run(str(tmp_path / "part.npz"), part, None)
    run(str(tmp_path / "resumed.npz"), budget, str(tmp_path / "part.npz"))
    whole, resumed = _snapshot(tmp_path / "whole.npz"), _snapshot(tmp_path / "resumed.npz")
    assert sorted(whole) == sorted(resumed) and int(whole["steps"]) == budget
    for key in whole:
        np.testing.assert_array_equal(whole[key], resumed[key], err_msg=key)


def _hard():
    import os

    from odesat_tpu_torch.cnf import parse_dimacs_file

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "hard.cnf")
    return normalize_cnf_variables(parse_dimacs_file(path))[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "stream"])
def test_ode_resume_equals_the_uninterrupted_run_on_the_card(cuda, tmp_path, kernel):
    """hard.cnf B=512 fixed through B1 and through B2 (forced): a snapshot
    at 96 steps resumed to 200 (a tail of 8) equals the run that never
    stopped."""
    from odesat_tpu_torch.ops import stream_chunk as stc

    formula = _hard()
    counter = (fc, "launches") if kernel == "fused" else (stc, "launches")
    before = getattr(*counter)

    def run(path, steps, resume):
        config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=steps, dv_strategy=kernel),
                              batch_size=512, seed=2, chunk_steps=32, checkpoint_path=path,
                              checkpoint_every_chunks=1, resume_from=resume)
        simulate_batch(formula, config, device=cuda)

    _resume_equals_whole(tmp_path, run, 200, 96)
    assert getattr(*counter) > before


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["stoch_fused", "stoch_stream"])
def test_stoch_resume_equals_the_uninterrupted_run_on_the_card(cuda, tmp_path, kernel):
    """B3 on hard.cnf and B4 on a random 5-SAT past B3's gate (n=2000,
    m=16000, ratio 8, where the parallel flips stall: no chain solves, so
    every chunk is snapshotted), B=256: the resumed run draws the launches'
    seeds from the restored generator and flips as the run that never
    stopped."""
    from odesat_tpu_torch.models.stoch import search
    from odesat_tpu_torch.ops import stoch_chunk as sc

    if kernel == "stoch_fused":
        formula = _hard()
    else:
        formula = normalize_cnf_variables(random_ksat(2000, 16000, k=5, seed=11))[1]
    attr = "fused_launches" if kernel == "stoch_fused" else "stream_launches"
    before = getattr(sc, attr)

    def run(path, steps, resume):
        config = SolverConfig(ode=ODEConfig(steps=steps), batch_size=256, seed=4,
                              chunk_steps=16, checkpoint_path=path, checkpoint_every_chunks=1,
                              resume_from=resume)
        search(formula, config, device=cuda)

    _resume_equals_whole(tmp_path, run, 100, 48)
    assert getattr(sc, attr) > before


@pytest.mark.cuda
def test_hybrid_through_b1_and_b3_and_its_resume(cuda, tmp_path):
    """hard.cnf B=1024: the hybrid ends "none" after exactly its budget (no
    multiple of the chunk) through B1 and B3, and its resume equals the run
    that never stopped."""
    from odesat_tpu_torch.models.hybrid import hybrid_search
    from odesat_tpu_torch.ops import stoch_chunk as sc

    formula = _hard()
    b1, b3 = fc.launches, sc.fused_launches
    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=100), batch_size=1024, seed=0,
                          chunk_steps=32)
    result = hybrid_search(formula, config, device=cuda)
    assert (result.engine, result.solved, result.steps) == ("none", False, 100)
    assert fc.launches - b1 == 4 and sc.fused_launches - b3 == 4
    assert result.engine_seconds["ode"] > 0 and result.engine_seconds["stoch"] > 0

    def run(path, steps, resume):
        hybrid_search(formula, SolverConfig(
            ode=ODEConfig(step_size=0.01, steps=steps), batch_size=1024, seed=0,
            chunk_steps=32, checkpoint_path=path, checkpoint_every_chunks=1,
            resume_from=resume), device=cuda)

    _resume_equals_whole(tmp_path, run, 100, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 48])
def test_solve_exact_through_b1_equals_its_single_step_replay(cuda, chunk):
    """uf250 seed 0, B=1024, fixed dt=0.01: the bisected step is the first
    at which one-step B1 launches from the same state have any row done."""
    from odesat_tpu_torch.utils.generate import uf_instance
    from odesat_tpu_torch.utils.tts import solve_exact

    fa = compile_formula(normalize_cnf_variables(uf_instance(250, seed=0))[1])
    ode = ODEConfig(step_size=0.01)
    before = fc.launches
    res = solve_exact(fa, ode, 1024, torch.Generator(device=cuda).manual_seed(0), chunk, 20000,
                      readout=True, device=cuda)
    assert res.solved and fc.launches > before
    one = fc.make_fused_chunk(fa, ode.resolve_zeta(fa.density), ode, 1, cuda)
    state = tode.init_state(fa, 1024, torch.Generator(device=cuda).manual_seed(0), ode, cuda)
    truth = None
    for step in range(1, res.steps + 1):
        state = one(state)
        if bool(state.done.any()):
            truth = step
            break
    assert truth == res.steps
    assert res.chunks == 1  # one dispatch of the device loop


# ------------------------------------------------------- the device loop


def _partly_solved(fa, B, seed, device):
    """A state of ``B`` rows with every fourth row done at entry (the rows
    it holds frozen, as a multi-chunk loop meets them)."""
    state = _state(fa, B, seed, device)
    done = state.done.clone()
    done[::4] = True
    return state._replace(done=done)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "stream"])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("stop_on", ["any", "all"])
@pytest.mark.parametrize("bound", [0, 1, 3, 60])
def test_device_loop_equals_the_host_loop_through_b1_and_b2(cuda, kernel, mode, stop_on, bound):
    """A planted 3-SAT at B=64 from the all-running start and from a state
    with done rows, every bound: one graph launch gives the host loop's
    state bit for bit and its steps; B1's and B2's counts grow by the
    chunks run."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.ops import device_loop
    from odesat_tpu_torch.ops import stream_chunk as stc

    fa = compile_formula(normalize_cnf_variables(random_ksat(50, 200, seed=3, planted=True))[1])
    ode = ODEConfig(step_size=0.05 if mode == "fixed" else None)
    make = fc.make_fused_chunk if kernel == "fused" else stc.make_stream_chunk
    fn = make(fa, 0.05, ode, 8, cuda)
    mod = fc if kernel == "fused" else stc
    for state in (_state(fa, 64, 2, cuda), _partly_solved(fa, 64, 2, cuda)):
        want, steps = run_chunks(fn, 8, bound, stop_all=stop_on == "all")(copy_state(state))
        graphs, before = device_loop.launches, mod.launches
        got, got_steps = device_loop.run(fn, state, bound, stop_all=stop_on == "all")
        torch.cuda.synchronize()
        assert device_loop.launches == graphs + 1
        assert got_steps == steps and mod.launches == before + steps // 8
        for name in ("v", "xs", "xl", "dt", "done"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "stream"])
@pytest.mark.parametrize("bound", [0, 1, 5, 200])
def test_device_loop_equals_the_host_loop_through_b3_and_b4(cuda, kernel, bound):
    """The stoch multi runner on the card (one graph launch, the seeds read
    on the card) against the host loop over the same kernel and a generator
    of the same seed: the same chains flip for flip, the same steps, and a
    dispatch that ran every chunk leaves the generators equal."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.models.stoch import (
        draw_seed,
        init_stoch_state,
        make_multi_stoch_runner,
    )
    from odesat_tpu_torch.ops import device_loop
    from odesat_tpu_torch.ops import stoch_chunk as sc

    fa = compile_formula(normalize_cnf_variables(random_ksat(40, 140, seed=3, planted=True))[1])
    state = init_stoch_state(fa, 200, cuda)
    gens = [torch.Generator().manual_seed(7) for _ in range(2)]
    chunks = []
    for g in gens:  # the chunk runner of models/stoch.py, at either kernel
        fn = sc.make_stoch_chunk(fa, 8, kernel, "float32", cuda)
        chunks.append(dataclasses.replace(fn, fn=lambda st, g=g, fn=fn: fn(st, draw_seed(g)),
                                          generator=g))
    want, steps = run_chunks(chunks[0], 8, bound)(copy_state(state))
    graphs = device_loop.launches
    got, got_steps = make_multi_stoch_runner(chunks[1], 8, bound)(state)
    torch.cuda.synchronize()
    assert device_loop.launches == graphs + 1 and got_steps == steps
    for name in ("v", "xl", "done"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if steps == 8 * bound:
        assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.cuda
def test_device_loop_from_a_stopped_state_runs_no_chunk(cuda):
    """Every row done ("all") or one row done ("any") at entry: the graph
    launches, runs no chunk and hands the state back unchanged."""
    from odesat_tpu_torch.ops import device_loop

    fa = compile_formula(_formula())
    fn = fc.make_fused_chunk(fa, 0.05, ODEConfig(step_size=0.02), 8, cuda)
    state = _state(fa, 37, 0, cuda)
    for stop_all, rows in ((False, [5]), (True, list(range(37)))):
        done = state.done.clone()
        done[rows] = True
        entry = state._replace(done=done)
        kept = copy_state(entry)
        before = fc.launches
        out, steps = device_loop.run(fn, entry, 10, stop_all=stop_all)
        torch.cuda.synchronize()
        assert steps == 0 and fc.launches == before
        for name in ("v", "xs", "xl", "dt", "done"):
            assert torch.equal(getattr(out, name), getattr(kept, name)), name


@pytest.mark.cuda
def test_a_graph_that_cannot_be_built_raises(cuda, monkeypatch):
    """A body launch that the kernel's entry refuses (a CTA of 2000
    threads) raises from the device loop with the CUDA error, and the
    multi-chunk runner never turns to the host loop; a good graph builds
    afterwards."""
    from odesat_tpu_torch.models import loop
    from odesat_tpu_torch.ops import device_loop

    fa = compile_formula(_formula())
    ode = ODEConfig(step_size=0.02)
    fn = fc.make_fused_chunk(fa, 0.05, ode, 8, cuda)
    state = _state(fa, 37, 0, cuda)
    monkeypatch.setattr(fc, "lane_threads", lambda *a: 2000)
    monkeypatch.setattr(loop, "run_chunks", lambda *a, **k: pytest.fail("fell back"))
    multi = tode.make_multi_chunk_runner(fa, 0.05, ode, 8, 4, cuda, chunk=fn)
    with pytest.raises(RuntimeError, match="fused chunk kernel launch failed"):
        multi(state)
    monkeypatch.undo()
    out, steps = device_loop.run(fn, copy_state(state), 4)
    want = state
    for _ in range(steps // 8):
        want = fn(want)
    torch.cuda.synchronize()
    assert steps == 32 and torch.equal(out.v, want.v) and torch.equal(out.done, want.done)


# ------------------------------------------ the trajectory mesh's device loop


def _mesh_loop_cases(B=64):
    """Cases of ``parallel/sharded.loop_against_host_loop`` over two
    trajectory ranks: B1 and B2 (forced) on a planted 3-SAT (n=50, m=200)
    at bounds 1, 3, 16 and 60, stop on any and all, and from a state
    stopped at entry on rank 1 only (one of its rows done for any, every
    one for all); B3 on the same formula and B4 on a planted 5-SAT past
    B3's gate (n=2000, m=8000), bounds 1, 3 and 16 and rank 1's chain done
    at entry."""
    fa = compile_formula(normalize_cnf_variables(random_ksat(50, 200, seed=3, planted=True))[1])
    fa5 = compile_formula(normalize_cnf_variables(
        random_ksat(2000, 8000, k=5, seed=11, planted=True))[1])
    rng = np.random.default_rng(5)
    xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
    base = (rng.uniform(-1, 1, (B, fa.n_vars_padded)).astype(np.float32), xs, np.ones_like(xs),
            np.full(B, 0.01, np.float32), np.zeros(B, bool))

    def entry(arrays, rows):
        done = arrays[-1].copy()
        done[rows] = True
        return (*arrays[:-1], done)

    cases = []
    for kernel in ("fused", "stream"):
        ode = ODEConfig(step_size=0.05, dv_strategy=kernel)
        for rule in ("any", "all"):
            cases += [("ode", fa, ode, 8, bound, rule, base) for bound in (1, 3, 16, 60)]
            cases.append(("ode", fa, ode, 8, 16, rule,
                          entry(base, [B - 1] if rule == "any" else list(range(B // 2, B)))))
    for f in (fa, fa5):
        chains = (rng.random((B, f.n_vars_padded)) < 0.5,
                  np.ones((B, f.n_clauses_padded), np.int32), np.zeros(B, bool))
        cases += [("stoch", f, "on", 8, bound, 7, chains) for bound in (1, 3, 16)]
        cases.append(("stoch", f, "on", 8, 16, 7, entry(chains, [B - 1])))
    return cases


@pytest.mark.cuda
def test_mesh_device_loop_equals_the_host_loop_through_b1_to_b4(cuda):
    """Two trajectory ranks sharing the card: each dispatch of the mesh's
    device loop (one graph launch a rank, the stop exchanged on the card)
    equals run_chunks with MeshSync over the same kernel bit for bit,
    steps_advanced included, with the stop inside a dispatch and at entry on
    rank 1 only; the kernels' counts grow by the chunks run."""
    from odesat_tpu_torch.parallel import launch, sharded

    cases = _mesh_loop_cases()
    values = launch.spawn(sharded.loop_against_host_loop, 2, 1, "gloo", "cuda", timeout_s=600,
                          args=(cases,))
    inside = False
    for case, (err, steps, host_steps, graphs, launches) in zip(cases, values):
        chunk_steps, bound = case[3], case[4]
        assert err == 0.0 and steps == host_steps, case[:6]
        assert graphs == 1 and launches == steps // chunk_steps, case[:6]
        entry = case[-1][-1].any()
        if entry and (case[0] == "stoch" or case[5] == "any"):
            assert steps == 0
        inside |= not entry and 0 < steps < bound * chunk_steps
    assert inside
    for report in launch.last_reports:
        assert report["device_loop_mesh"] == report["device_loop"] == len(cases)


@pytest.mark.cuda
def test_a_rank_whose_peer_never_dispatches_raises(cuda):
    """Rank 1 shares the exchange pages and never dispatches: rank 0's
    exchange waits the collective timeout (2 s), its dispatch raises naming
    rank 1, and the world ends (rank 1's process killed) instead of
    hanging."""
    import multiprocessing
    import time

    from odesat_tpu_torch.parallel import launch, sharded

    fa = compile_formula(_formula())
    t0 = time.monotonic()
    with pytest.raises(launch.WorkerError, match=r"did not arrive") as info:
        launch.spawn(sharded.dispatch_alone, 2, 1, "gloo", "cuda", timeout_s=300, args=(fa,),
                     collective_timeout_s=2)
    assert "[(1, 1)]" in str(info.value)
    assert time.monotonic() - t0 < 100  # start-up and the 2 s wait, not the 120 s sleep
    assert not multiprocessing.active_children()


# ------------------------------------------------------- the scan chunk


def _scan_case(strategy, mode, dtype, device, chunk_steps=8):
    """A planted 3-SAT (every clause of width 3, as B10 takes), its scan
    chunk and the step it captures, built for ``device``."""
    fa = compile_formula(normalize_cnf_variables(random_ksat(50, 200, seed=3, planted=True))[1])
    ode = ODEConfig(step_size=0.05 if mode == "fixed" else None, dtype=dtype,
                    dt_mode="shared" if mode == "shared" else "per-trajectory",
                    dv_strategy=strategy)
    chunk = tode.make_chunk_runner(fa, 0.05, ode, chunk_steps, device)
    step = tode.make_step_fn(fa, 0.05, ode, device=device)
    dev = tode.formula_device(fa, device, tode.state_dtype(ode))
    return fa, ode, chunk, step, dev


def _scan_state(fa, B, seed, dtype, device):
    state = _state(fa, B, seed, "cpu")
    dt = torch.float64 if dtype == "float64" else torch.float32
    return type(state)(*(t.to(device=device, dtype=dt) if t.is_floating_point() else
                         t.to(device) for t in state))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["fixed", "adaptive", "shared"])
@pytest.mark.parametrize("strategy", ["gather", "segment_sum", "pallas"])
def test_scan_chunk_equals_the_step_loop(cuda, strategy, mode, dtype):
    """The captured 8-step chunk at B=37 against the same steps launched one
    by one: bit-identical, twice (segment_sum included: its tree sums in a
    fixed order); one capture (the first result copied and dropped, so its
    buffers are free again); each replay counts one graph chunk and B10's
    launches of 8 steps (one a fixed step, two an adaptive one)."""
    from odesat_tpu_torch.ops import rhs_kernel as rk
    from odesat_tpu_torch.ops import scan_chunk

    fa, ode, chunk, step, dev = _scan_case(strategy, mode, dtype, cuda)
    state = _scan_state(fa, 37, 1, dtype, cuda)
    want = state
    for _ in range(8):
        want = step(want, dev)
    before = (scan_chunk.launches, rk.launches)
    got = copy_state(chunk(state, dev))
    again = chunk(state, dev)
    torch.cuda.synchronize()
    per_step = 0 if strategy != "pallas" else (1 if mode == "fixed" else 2)
    assert (scan_chunk.launches, rk.launches) == (before[0] + 2, before[1] + 2 * 8 * per_step)
    assert len(chunk.graphs) == 1
    for name, a, b, c in zip(state._fields, got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("stop_on", ["any", "all"])
@pytest.mark.parametrize("bound", [0, 1, 3, 40])
@pytest.mark.parametrize("strategy", ["segment_sum", "pallas"])
def test_device_loop_over_the_scan_chunk_equals_run_chunks(cuda, strategy, stop_on, bound):
    """The multi-chunk runner on a CUDA state (one graph launch: the
    captured chunk as the WHILE node's body, then the stop kernel) against
    the host loop over the same chunk, from the all-running start and from
    a state with done rows: the same state bit for bit, the same steps, and
    the counts of the chunks run."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.ops import device_loop
    from odesat_tpu_torch.ops import rhs_kernel as rk
    from odesat_tpu_torch.ops import scan_chunk

    fa, ode, chunk, step, dev = _scan_case(strategy, "fixed", "float32", cuda)
    multi = tode.make_multi_chunk_runner(fa, 0.05, ode, 8, bound, cuda, stop_on=stop_on,
                                         chunk=chunk)
    for state in (_state(fa, 64, 2, cuda), _partly_solved(fa, 64, 2, cuda)):
        want, steps = run_chunks(lambda st: chunk(st, dev), 8, bound,
                                 stop_all=stop_on == "all")(state)
        graphs, before = device_loop.launches, (scan_chunk.launches, rk.launches)
        got, got_steps = multi(state, dev)
        torch.cuda.synchronize()
        chunks = steps // 8
        assert device_loop.launches == graphs + 1 and got_steps == steps
        b10 = 8 * chunks if strategy == "pallas" else 0
        assert (scan_chunk.launches, rk.launches) == (before[0] + chunks, before[1] + b10)
        for name in ("v", "xs", "xl", "dt", "done"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_scan_graphs_share_one_pool_and_replay_in_any_order(cuda):
    """Two runners (8 steps of the twin, 3 of B10, adaptive) capture into
    the device's one pool; replayed alternately, each equals its step loop
    every time."""
    fa, ode, a, step_a, dev = _scan_case("gather", "adaptive", "float32", cuda)
    _, ode_b, b, step_b, _ = _scan_case("pallas", "adaptive", "float32", cuda, chunk_steps=3)
    state = _state(fa, 64, 4, cuda)
    outs = []
    for chunk, step, n in ((a, step_a, 8), (b, step_b, 3), (a, step_a, 8), (b, step_b, 3)):
        want = state
        for _ in range(n):
            want = step(want, dev)
        outs.append((copy_state(chunk(state, dev)), want))
    torch.cuda.synchronize()
    (cap_a,), (cap_b,) = a.graphs.values(), b.graphs.values()
    assert cap_a.parts[0][0].pool() == cap_b.parts[0][0].pool()
    for got, want in outs:
        for name, x, y in zip(state._fields, got, want):
            assert torch.equal(x, y), name


@pytest.mark.cuda
def test_a_capture_after_every_graph_of_the_pool_died(cuda):
    """Runner A captures and replays, then dies with its graphs, and the
    allocator releases their pool; runner B then captures (into a pool of
    its own: the dead pool's handle would trip the allocator's assert) and
    equals its step loop bit for bit, twice."""
    import gc

    from odesat_tpu_torch.ops import scan_chunk

    fa, _, a, _, dev = _scan_case("gather", "fixed", "float32", cuda)
    state = _state(fa, 64, 5, cuda)
    a(state, dev)
    torch.cuda.synchronize()
    del a
    gc.collect()
    assert not scan_chunk._POOLS[state.v.device][1]  # no graph of the pool lives
    _, _, b, step, _ = _scan_case("pallas", "adaptive", "float32", cuda)
    want = state
    for _ in range(8):
        want = step(want, dev)
    got, again = b(state, dev), b(state, dev)
    torch.cuda.synchronize()
    for name, x, y, z in zip(state._fields, got, want, again):
        assert torch.equal(x, y) and torch.equal(x, z), name


@pytest.mark.cuda
def test_a_capture_that_raises_leaves_the_next_one_correct(cuda):
    """A step that reads a value back to the host (``.item()``) cannot be
    captured: the runner's first call raises, keeps no graph and counts no
    B10 launch; a good runner then captures into the same pool and equals
    its step loop bit for bit."""
    from odesat_tpu_torch.ops import rhs_kernel as rk
    from odesat_tpu_torch.ops import scan_chunk

    fa, _, good, step, dev = _scan_case("pallas", "fixed", "float32", cuda)

    def reads_back(state, dev):
        state = step(state, dev)
        state.v.sum().item()
        return state

    bad = scan_chunk.make_scan_chunk(reads_back, 4, cuda)
    state = _state(fa, 37, 7, cuda)
    before = (scan_chunk.launches, rk.launches)
    with pytest.raises(RuntimeError):
        bad(state, dev)
    assert bad.graphs == {} and (scan_chunk.launches, rk.launches) == before
    want = state
    for _ in range(8):
        want = step(want, dev)
    got = good(state, dev)
    torch.cuda.synchronize()
    for name, x, y in zip(state._fields, got, want):
        assert torch.equal(x, y), name


@pytest.mark.cuda
def test_a_chunk_longer_than_a_graph_runs_its_parts(cuda):
    """A chunk of MAX_GRAPH_STEPS + 3 steps (B10, fixed) is a graph of
    MAX_GRAPH_STEPS steps and one of 3: called directly and under the device
    loop it equals the steps launched one by one bit for bit, and B10
    counts every step."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.ops import rhs_kernel as rk
    from odesat_tpu_torch.ops import scan_chunk

    n = scan_chunk.MAX_GRAPH_STEPS + 3
    fa, ode, chunk, step, dev = _scan_case("pallas", "fixed", "float32", cuda, chunk_steps=n)
    state = _state(fa, 37, 6, cuda)
    want = state
    for _ in range(n):
        want = step(want, dev)
    before = rk.launches
    got = chunk(state, dev)
    torch.cuda.synchronize()
    (cap,) = chunk.graphs.values()
    assert [times for _, times in cap.parts] == [1, 1] and rk.launches == before + n
    for name, a, b in zip(state._fields, got, want):
        assert torch.equal(a, b), name
    multi = tode.make_multi_chunk_runner(fa, 0.05, ode, n, 2, cuda, stop_on="all", chunk=chunk)
    host, host_steps = run_chunks(lambda st: chunk(st, dev), n, 2, stop_all=True)(state)
    got, steps = multi(state, dev)
    torch.cuda.synchronize()
    assert steps == host_steps > 0
    for name, a, b in zip(state._fields, got, host):
        assert torch.equal(a, b), name


def _stoch_twin(device, n, seed=3, planted=False):
    """The stoch twin's chunk of n steps (ops/scan_chunk.StochScanChunk) on
    a 3-SAT of 50 variables (200 clauses; planted: satisfiable), its step,
    and chains of v random, xl random in [1, 60] at B=37."""
    from odesat_tpu_torch.interop import stoch_state_from_numpy
    from odesat_tpu_torch.models.stoch import make_stoch_chunk_runner, make_stoch_step

    fa = compile_formula(normalize_cnf_variables(
        random_ksat(50, 200 if planted else 230, seed=5, planted=planted))[1])
    chunk = make_stoch_chunk_runner(fa, n, device, torch.Generator().manual_seed(seed),
                                    fused="off")
    rng = np.random.default_rng(seed)
    B, Np, Mp = 37, fa.n_vars_padded, fa.n_clauses_padded
    state = stoch_state_from_numpy(rng.random((B, Np)) < 0.5,
                                   rng.integers(1, 61, (B, Mp)).astype(np.int32),
                                   np.zeros(B, bool), device=device)
    return fa, chunk, make_stoch_step(fa, device), state


def _host_paced(step, state, n, gen, Np):
    """n steps launched from Python, each drawing its uniforms from gen."""
    for _ in range(n):
        state = step(state, torch.rand((state.v.shape[0], Np), generator=gen,
                                       device=state.v.device))
    return state


def _twin_gen(chunk, device):
    gen = torch.Generator(device=device)
    gen.set_state(chunk.device_generator.get_state())
    return gen


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 64, 100])
def test_stoch_scan_chunk_equals_the_host_paced_loop(cuda, n):
    """Three chunks of the captured stoch twin (one graph; 64 steps; a
    graph of 64 and one of 36) against the same steps launched from Python
    with a copy of its device generator: v, xl and done bit for bit after
    every chunk, and the two generators in one state; one capture, three
    stoch graph chunks counted."""
    from odesat_tpu_torch.ops import scan_chunk

    fa, chunk, step, state = _stoch_twin(cuda, n)
    gen = _twin_gen(chunk, cuda)
    before = (scan_chunk.launches, scan_chunk.stoch_launches)
    got = want = state
    for _ in range(3):
        got = chunk(got)
        want = _host_paced(step, want, n, gen, fa.n_vars_padded)
        torch.cuda.synchronize()
        for name, a, b in zip(state._fields, got, want):
            assert torch.equal(a, b), name
        assert torch.equal(chunk.device_generator.get_state(), gen.get_state())
    assert (scan_chunk.launches, scan_chunk.stoch_launches) == (before[0], before[1] + 3)
    (cap,) = chunk.graphs.values()
    assert [times for _, times in cap.parts] == ([1, 1] if n == 100 else [1])
    assert (got.v != state.v).any()


@pytest.mark.cuda
def test_stoch_scan_snapshot_resumes_to_the_same_flips(cuda):
    """Two captured 100-step chunks, the generators' states saved
    (models/stoch.generator_states), two more: the uninterrupted run. The
    same runner set back to the saved state, and a runner built anew from
    another seed with the states restored (restore_generators), each run
    two chunks from the saved chains to the same chains bit for bit and the
    same device generator state."""
    from odesat_tpu_torch.models.stoch import (
        generator_states,
        make_stoch_chunk_runner,
        restore_generators,
    )

    fa, chunk, _, state = _stoch_twin(cuda, 100)
    cpu_gen = torch.Generator().manual_seed(0)
    mid = chunk(chunk(state))
    saved = generator_states(cpu_gen, chunk)
    want = chunk(chunk(copy_state(mid)))  # a call consumes its input
    final = chunk.device_generator.get_state()
    fresh_gen = torch.Generator().manual_seed(8)
    fresh = make_stoch_chunk_runner(fa, 100, cuda, fresh_gen, fused="off")
    for runner, gen in ((chunk, torch.Generator()), (fresh, fresh_gen)):
        restore_generators(saved, gen, runner)
        got = runner(runner(copy_state(mid)))
        torch.cuda.synchronize()
        for name, a, b in zip(state._fields, got, want):
            assert torch.equal(a, b), name
        assert torch.equal(runner.device_generator.get_state(), final)
        assert torch.equal(gen.get_state(), cpu_gen.get_state())


@pytest.mark.cuda
def test_stoch_scan_chunk_stays_off_the_device_loop(cuda):
    """The device loop refuses the twin's chunk (only the host advances its
    generator); the multi-chunk runner over it on a CUDA state is the host
    loop: no graph launch, the same chains, steps and generator state as
    run_chunks over a twin with a copy of its generator, the stop inside
    the dispatch."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.models.stoch import make_multi_stoch_runner
    from odesat_tpu_torch.ops import device_loop

    fa, chunk, _, state = _stoch_twin(cuda, 8, planted=True)
    _, other, _, _ = _stoch_twin(cuda, 8, planted=True)
    with pytest.raises(RuntimeError, match="device generator"):
        device_loop.run(chunk, state, 2)
    graphs = device_loop.launches
    got, steps = make_multi_stoch_runner(chunk, 8, 200)(state)
    want, want_steps = run_chunks(other, 8, 200)(state)
    torch.cuda.synchronize()
    assert device_loop.launches == graphs
    assert steps == want_steps and 0 < steps < 8 * 200 and bool(got.done.any())
    for name, a, b in zip(state._fields, got, want):
        assert torch.equal(a, b), name
    assert torch.equal(chunk.device_generator.get_state(), other.device_generator.get_state())


# ------------------------------------------------------- donation


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "stream", "stoch_fused", "stoch_stream"])
def test_chunk_kernels_in_place_equal_out_of_place(cuda, kernel):
    """B1-B4 host-paced: a donating runner runs in place on its input and
    returns its tensors, bit for bit what the runner built with
    donate=False writes into new tensors, which leaves its input as it
    was."""
    from odesat_tpu_torch.models.stoch import init_stoch_state
    from odesat_tpu_torch.ops import stoch_chunk as sc
    from odesat_tpu_torch.ops import stream_chunk as stc

    fa = compile_formula(normalize_cnf_variables(random_ksat(50, 200, seed=3, planted=True))[1])
    if kernel.startswith("stoch"):
        make = lambda donate: (lambda fn: lambda st: fn(st, 99))(  # noqa: E731
            sc.make_stoch_chunk(fa, 16, kernel[6:], "float32", cuda, donate))
        state = init_stoch_state(fa, 77, cuda)
    else:
        build = fc.make_fused_chunk if kernel == "fused" else stc.make_stream_chunk
        make = lambda donate: (lambda fn: lambda st: fn(st))(  # noqa: E731
            build(fa, 0.05, ODEConfig(), 16, cuda, donate))
        state = _state(fa, 77, 3, cuda)
    entry = copy_state(state)
    kept = make(False)(state)
    torch.cuda.synchronize()
    for name, a, b in zip(state._fields, state, entry):
        assert torch.equal(a, b), name  # donate=False left its input
    ptrs = [t.data_ptr() for t in state]
    got = make(True)(state)
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in got] == ptrs
    for name, a, b in zip(state._fields, got, kept):
        assert torch.equal(a, b), name
    assert (kept.v != entry.v).any()


def _dispatch_case(kind, cuda):
    """A multi-chunk runner over B1 (``kind`` "fused") or the scan chunk
    (the twin's gather step), 4 chunks of 8 steps stopping when every row
    is done, its chunk, the formula tensors and a state maker."""
    fa = compile_formula(normalize_cnf_variables(random_ksat(50, 200, seed=3, planted=True))[1])
    ode = ODEConfig(step_size=0.05, dv_strategy="fused" if kind == "fused" else "gather")
    chunk = tode.make_chunk_runner(fa, 0.05, ode, 8, cuda)
    multi = tode.make_multi_chunk_runner(fa, 0.05, ode, 8, 4, cuda, stop_on="all", chunk=chunk)
    dev = tode.formula_device(fa, cuda)
    return multi, chunk, dev, lambda seed: _state(fa, 64, seed, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fused", "scan"])
def test_a_dispatch_from_its_own_result_runs_in_place_with_no_copy_and_no_capture(cuda, kind):
    """Dispatches that pass each result back, as drive_chunks does: after
    the first, no copy into a graph's buffers, no new graph or capture; B1's
    dispatch runs on the caller's tensors from the first one (the pointer
    block); every result equals the host loop over the same chunk bit for
    bit."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.ops import device_loop, scan_chunk

    multi, chunk, dev, make = _dispatch_case(kind, cuda)
    host = run_chunks(lambda st: chunk(st, dev), 8, 4, stop_all=True)
    wants, st = [], make(1)
    for _ in range(4):  # the host loop's results first: they hold no buffers after
        st = host(st)[0]
        wants.append(copy_state(st))
    del st
    state = make(1)
    ptrs, first = [t.data_ptr() for t in state], device_loop.loads
    state, _ = multi(state, dev)
    loads, captures, graphs = device_loop.loads, scan_chunk.captures, len(chunk.loops)
    for i, want in enumerate(wants):
        if i:
            state, _ = multi(state, dev)
        torch.cuda.synchronize()
        for name, a, b in zip(want._fields, state, want):
            assert torch.equal(a, b), name
    assert (device_loop.loads, scan_chunk.captures, len(chunk.loops)) == (loads, captures, graphs)
    if kind == "fused":
        assert [t.data_ptr() for t in state] == ptrs and device_loop.loads == first


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "stream"])
def test_stoch_dispatches_from_their_own_results_copy_only_at_the_first(cuda, kernel):
    """B3 and B4 run their graphs on the runner's buffer sets: dispatches
    that pass each result back equal the host loop over a generator of the
    same seed bit for bit, copy the state in at the first dispatch only and
    build one graph."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.models.stoch import init_stoch_state, make_multi_stoch_runner
    from odesat_tpu_torch.models.stoch import make_stoch_chunk_runner
    from odesat_tpu_torch.ops import device_loop

    fa = compile_formula(normalize_cnf_variables(random_ksat(40, 170, seed=4))[1])
    gens = [torch.Generator().manual_seed(7) for _ in range(2)]
    chunks = [make_stoch_chunk_runner(fa, 8, cuda, g, fused="on") for g in gens]
    if kernel == "stream":  # B4 on the same formula: the stream kernel's runner
        from odesat_tpu_torch.models.stoch import draw_seed
        from odesat_tpu_torch.ops import stoch_chunk as sc

        chunks = [dataclasses.replace(f, fn=lambda st, g=g, f=f: f(st, draw_seed(g)),
                                      generator=g)
                  for g, f in zip(gens, (sc.make_stoch_chunk(fa, 8, "stream", "float32", cuda)
                                         for _ in gens))]
    host = run_chunks(chunks[0], 8, 3)
    multi = make_multi_stoch_runner(chunks[1], 8, 3)
    want, state = init_stoch_state(fa, 100, cuda), init_stoch_state(fa, 100, cuda)
    loads = []
    for _ in range(3):
        want = host(want)[0]
        before = device_loop.loads
        state, _ = multi(state)
        loads.append(device_loop.loads - before)
        torch.cuda.synchronize()
        for name in ("v", "xl", "done"):
            assert torch.equal(getattr(state, name), getattr(want, name)), name
    assert loads == [1, 0, 0] and len(chunks[1].loops) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fused", "scan"])
@pytest.mark.parametrize("call", ["dispatch", "chunk"])
def test_a_held_result_is_unchanged_by_a_call_from_another_state(cuda, kind, call):
    """A result the caller holds stays as it came back after the same
    runner (its dispatch or its chunk) runs from another state, which
    itself equals its run alone."""
    multi, chunk, dev, make = _dispatch_case(kind, cuda)
    run = (lambda st: multi(st, dev)[0]) if call == "dispatch" else (lambda st: chunk(st, dev))
    alone = copy_state(run(make(2)))
    held = run(make(1))
    kept = copy_state(held)
    other = run(make(2))
    torch.cuda.synchronize()
    for name, a, b, c, d in zip(held._fields, held, kept, other, alone):
        assert torch.equal(a, b) and torch.equal(c, d), name


# ------------- the clause mesh's per-step chunks captured (ops/scan_chunk.py)


def _capture_cases(S):
    """(label, kind, formula, ode) of chip_smoke.captured_against_host_paced:
    B5 fixed and adaptive and the B8 path on a shard plan, and on a mesh
    the twins (a plain layout, float64 for the ODE's)."""
    fa = _sharded(S)
    cases = [("B5 fixed", "B5", fa, ODEConfig(step_size=0.01)),
             ("B5 adaptive", "B5", fa, ODEConfig(tolerance=1e-3)),
             ("B8", "B8", fa, None)]
    if S > 1:
        plain = compile_formula(_formula(seed=5), clause_pad=64 * S)
        cases += [("twin fixed", "twin", plain, ODEConfig(dtype="float64", step_size=0.01)),
                  ("twin adaptive", "twin", plain, ODEConfig(dtype="float64", tolerance=1e-3)),
                  ("stoch twin", "stoch_twin", plain, None)]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 45])
@pytest.mark.parametrize("case", range(3))
def test_captured_clause_chunk_equals_host_paced(cuda, case, B):
    """B5's chunk (fixed, adaptive) and the B8 path's at S=1, 70 steps (a
    64-step graph, then one of 6): two captured chunks equal the same steps
    launched from Python bit for bit, and the second captured chunk, from
    the first's result in its storage, replays two graphs and allocates
    nothing."""
    import chip_smoke

    label, kind, fa, ode = _capture_cases(1)[case]
    r = chip_smoke.captured_against_host_paced(None, cuda, kind, fa, ode, B, steps=70)
    assert r["err"] == 0.0, label
    assert r["allocs"] == 0 and r["replays"] == 2 and r["b7"] == 0, (label, r)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
def test_captured_clause_chunks_equal_host_paced_across_ranks_on_one_card(cuda, S):
    """At S ranks sharing the card, B5's chunk (fixed, adaptive), the B8
    path's, the twin's clause step (float64, fixed and adaptive) and the
    stoch clause twin's: two captured chunks of 70 steps, their B7 calls in
    the graphs with their flags rebased at each launch, equal the same
    steps launched from Python bit for bit on every rank, v bit-identical
    over the ranks, the second chunk allocating nothing; the B7 calls a
    chunk are its steps' (one a fixed step, three an adaptive one, one a
    stoch step)."""
    import chip_smoke
    from odesat_tpu_torch.parallel import launch

    cases = _capture_cases(S)
    calls = [(chip_smoke.captured_against_host_paced, (kind, fa, ode, 32, 70))
             for _, kind, fa, ode in cases]
    values = launch.spawn(launch.run_all, 1, S, "gloo", "cuda", timeout_s=900, args=(calls,))
    for (label, *_), r in zip(cases, values):
        assert r["err"] == 0.0 and r["allocs"] == 0, (label, r)
        assert r["b7"] == 70 * (3 if "adaptive" in label else 1), (label, r)
    for report in launch.last_reports:
        assert all(c["mesh_step_chunk"] > 0 for c in report["calls"])


@pytest.mark.cuda
def test_shared_twin_chunk_captured_on_a_trajectory_mesh(cuda):
    """The trajectory mesh's shared-adaptive twin (T=2 sharing the card,
    its error max over the trajectory group on B7 every step) captured
    equals host-paced bit for bit."""
    import chip_smoke
    from odesat_tpu_torch.parallel import launch

    fa = compile_formula(_formula(seed=5))
    ode = ODEConfig(tolerance=1e-3, dt_mode="shared")
    calls = [(chip_smoke.captured_against_host_paced, ("twin", fa, ode, 32, 40))]
    (r,) = launch.spawn(launch.run_all, 2, 1, "gloo", "cuda", timeout_s=600, args=(calls,))
    assert r["err"] == 0.0 and r["allocs"] == 0 and r["b7"] == 40, r


@pytest.mark.cuda
def test_host_and_card_counters_agree_after_mixed_chunks(cuda):
    """Two ranks sharing the card run B5 (captured), B6, the B8 path
    (captured) and B9 chunks in turn on one ring: the states equal the same
    rounds with B5 and B8 host-paced bit for bit, and every rank's flag on
    the card equals the host's count of the group's launches."""
    import chip_smoke
    from odesat_tpu_torch.parallel import launch

    calls = [(chip_smoke.mixed_chunks, (_sharded(2), 64, 7))]
    values = launch.spawn(launch.run_all, 1, 2, "gloo", "cuda", timeout_s=600, args=(calls,))
    for (err, count, flags) in values:
        assert err == 0.0 and flags == [count] * 2, (err, count, flags)
