"""The CUDA chunk kernel against its plain torch version, on the card.

These tests need an NVIDIA Hopper GPU and nvcc (the kernel has no CPU
mode) and skip without a CUDA device. The file imports no jax, so it runs
on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: float32 rtol 2e-4 / atol 2e-5 (tests/test_fused.py's), done
exact; repeats bit-identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu_torch.cnf import CNFFormula, compile_formula, normalize_cnf_variables  # noqa: E402
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.interop import state_from_numpy  # noqa: E402
from odesat_tpu_torch.models.ode import simulate_batch  # noqa: E402
from odesat_tpu_torch.ops import fused_chunk as fc  # noqa: E402
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
    out = fn(state)
    again = fn(state)
    ref = fc.fused_chunk_plain(state, fn.spec, 32)
    torch.cuda.synchronize()
    assert fc.launches == before + 2
    for name in ("v", "xs", "xl", "dt"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name), **F32)
    assert torch.equal(out.done, ref.done)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


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
        out = fn(state)
        ref = fc.fused_chunk_plain(state, fn.spec, 8)
        for name in ("v", "xs", "xl", "dt"):
            torch.testing.assert_close(getattr(out, name), getattr(ref, name), **F32)
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
        want = lib.fused_chunk_smem_bytes(fa.n_vars_padded, Mp, K, nnz, int(fixed))
        assert fc.fused_smem_bytes(fa, fixed) == want


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


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "stream"])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_stoch_kernel_matches_plain_as_chains_finish(cuda, kernel, matmul_dtype):
    """From the all-false start on a small planted formula, 8-step chunks
    until one holds chains done before it, chains finishing in it and
    chains running: kernel and plain version agree exactly, done chains
    stay put, and a repeat is bit-identical."""
    from odesat_tpu_torch.models.stoch import init_stoch_state
    from odesat_tpu_torch.ops import stoch_chunk as sc

    fa = compile_formula(normalize_cnf_variables(random_ksat(40, 140, seed=3, planted=True))[1])
    fn = sc.make_stoch_chunk(fa, 8, kernel, matmul_dtype, cuda)
    B, bf16, seen = 200, matmul_dtype == "bfloat16", False
    state = init_stoch_state(fa, B, cuda)
    counter = "fused_launches" if kernel == "fused" else "stream_launches"
    for seed in range(1, 500):
        before_launches = getattr(sc, counter)
        out = fn(state, seed)
        again = fn(state, seed)
        ref = sc.stoch_chunk_plain(state, fn.spec, 8, seed, sc.traj_block(B), bf16)
        torch.cuda.synchronize()
        assert getattr(sc, counter) == before_launches + 2
        for a, b, c in zip(out, ref, again):
            assert torch.equal(a, b) and torch.equal(a, c)
        was = state.done
        assert torch.equal(out.v[was], state.v[was]) and torch.equal(out.xl[was], state.xl[was])
        before, after = int(was.sum()), int(out.done.sum())
        state = out
        if 0 < before < after < B:
            seen = True
            break
    assert seen, "no chunk had chains done before it, chains finishing in it and chains running"


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(3,), (1, 2, 5)])
def test_stoch_b3_equals_b4_and_the_gates_match_the_kernel(cuda, widths):
    from odesat_tpu_torch.interop import stoch_state_from_numpy
    from odesat_tpu_torch.ops import stoch_chunk as sc

    fa = compile_formula(_formula(widths=widths), bucket=True, min_bucket=32)
    lib, _ = sc.load_library()
    K, Mp = fa.lit_var.shape
    nnz = int((fa.lit_mask > 0).sum())
    assert lib.stoch_fused_smem_bytes(fa.n_vars_padded, Mp, K, nnz) == sc.stoch_fused_smem_bytes(fa)
    assert lib.stoch_stream_smem_bytes(fa.n_vars_padded, Mp) == sc.stoch_stream_smem_bytes(fa)
    rng = np.random.default_rng(1)
    B = 1000  # two PRNG blocks of 512
    state = stoch_state_from_numpy(rng.random((B, fa.n_vars_padded)) < 0.5,
                                   rng.integers(1, 3000, (B, Mp)), np.zeros(B, bool), cuda)
    outs = [sc.make_stoch_chunk(fa, 16, k, "float32", cuda)(state, 77) for k in ("fused", "stream")]
    ref = sc.stoch_chunk_plain(state, sc.stoch_spec(fa, cuda), 16, 77, 512, False)
    torch.cuda.synchronize()
    for a, b, c in zip(*outs, ref):
        assert torch.equal(a, b) and torch.equal(a, c)


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
    out, again = fn(state), fn(state)
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
        out = fn(state)
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
    """The gate's shared-memory limit is the card's, and the kernel runs
    the largest layout the gate makes: the locally-structured n=4096
    instance (Mp=17280), whose clause arrays spill to the scratch rows."""
    from odesat_tpu_torch.ops import stream_chunk as sc
    from odesat_tpu_torch.utils.generate import random_local_ksat

    lib, _ = sc.load_library()
    assert lib.stream_chunk_smem_limit() == sc.SMEM_LIMIT_BYTES
    fa = compile_formula(normalize_cnf_variables(
        random_local_ksat(4096, 17203, k=3, locality=256, seed=3))[1], window_sort=True)
    fixed = mode == "fixed"
    assert sc.stream_supported(fa, fixed) and not fc.fused_supported(fa, fixed)
    fn = sc.make_stream_chunk(fa, 0.01, ODEConfig(step_size=0.01 if fixed else None), 4, cuda)
    assert fn.spec.layout.row_words > 0 and fn.spec.layout.smem_bytes <= sc.SMEM_LIMIT_BYTES
    state = _state(fa, 3, 5, cuda)
    out, ref = fn(state), sc.stream_chunk_plain(state, fn.spec, 4)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("bucket", [False, True])
def test_rhs_kernel_matches_the_twin(cuda, dtype, rigidity, bucket):
    """B10 against the twin's gather RHS (the plain version): f32 to rtol
    2e-4 / atol 2e-5, f64 to 1e-12; the two sum in other orders."""
    from odesat_tpu_torch.ops import rhs_kernel as rk

    fa = compile_formula(_formula(widths=(2, 3, 5)), bucket=bucket, min_bucket=32)
    rng = np.random.default_rng(4)
    B = 33
    v = torch.as_tensor(rng.uniform(-1, 1, (B, fa.n_vars_padded)), dtype=dtype, device=cuda)
    xs = torch.as_tensor(rng.uniform(0.001, 0.999, (B, fa.n_clauses_padded)), dtype=dtype,
                         device=cuda)
    xl = torch.as_tensor(rng.uniform(1, 50, (B, fa.n_clauses_padded)), dtype=dtype, device=cuda)
    name = "float64" if dtype == torch.float64 else "float32"
    fn = rk.make_rhs_kernel(fa, 0.05, rigidity, name)
    dev = tode.formula_device(fa, cuda, dtype)
    before = rk.launches
    out = fn(v, xs, xl, dev)
    buckets = fa.bucket_slices if len(fa.bucket_slices) > 1 else None
    ref = rk.rhs_plain(v, xs, xl, dev, 0.05, rigidity, buckets)
    torch.cuda.synchronize()
    assert rk.launches == before + 1
    tol = F32 if dtype == torch.float32 else dict(rtol=1e-12, atol=1e-12)
    for a, b in zip(out[:3], ref[:3]):
        torch.testing.assert_close(a, b, **tol)
    assert torch.equal(out[3], ref[3])


# ------------- clause shards: B5 (shard RHS), B8 (stoch eval), B6 and B9 (chunks)


def _sharded(n_shards, widths=(2, 3, 5), seed=0):
    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded

    return compile_stream_sharded(_formula(seed=seed, widths=widths), n_shards, min_bucket=32)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("mode", ["rhs", "fixed", "second"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_shard_kernel_equals_plain(cuda, n_shards, mode, rigidity, matmul_dtype):
    """B5 in each mode equals its plain version bit for bit on every shard,
    the launch counter moves once a launch, and a repeat is identical."""
    from odesat_tpu_torch.ops import shard_stream as ss

    fa = _sharded(n_shards)
    ode = ODEConfig(step_size=0.02, rigidity=rigidity, matmul_dtype=matmul_dtype)
    rng = np.random.default_rng(3)
    B, ml = 37, fa.shard_plan.mp_local

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(cuda, dtype)

    v = put(rng.uniform(-1, 1, (B, fa.n_vars_padded)))
    for s in range(n_shards):
        spec = ss.shard_spec(fa, 0.05, ode, cuda, s)
        xs = put(rng.uniform(0.001, 0.999, (B, ml)))
        xl = put(rng.uniform(1, 50, (B, ml)))
        dt = put(rng.uniform(0, 0.05, B))
        adv = put(rng.random(B) < 0.7, torch.bool)
        dxs1, dxl1 = put(rng.uniform(-1, 1, (B, ml))), put(rng.uniform(-1, 1, (B, ml)))
        if mode == "rhs":
            args, plain = (v, xs, xl), ss.shard_rhs_plain
        elif mode == "fixed":
            args, plain = (v, dt, xs, xl), ss.shard_fixed_plain
        else:
            args, plain = (v, dt, adv, xs, xl, dxs1, dxl1), ss.shard_second_plain
        ref = plain(*args, spec)
        launch = {"rhs": ss.shard_rhs, "fixed": ss.shard_fixed, "second": ss.shard_second}[mode]
        before = ss.launches
        outs = [launch(*(a.clone() for a in args), spec) for _ in range(2)]
        torch.cuda.synchronize()
        assert ss.launches == before + 2
        for a, b, c in zip(outs[0], outs[1], ref):
            assert torch.equal(a, c) and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_single_device_runner_goes_through_b5(cuda, mode):
    from odesat_tpu_torch.ops import shard_stream as ss

    fa = _sharded(1, widths=(3,))
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None)
    state = _state(fa, 16, 1, cuda)
    before = ss.launches
    out = ss.make_single_device_runner(fa, 0.05, ode, 8, cuda)(state)
    torch.cuda.synchronize()
    assert ss.launches == before + (8 if mode == "fixed" else 16)
    ref = ss.make_single_device_runner(fa, 0.05, ode, 8, "cpu")(
        type(state)(*(t.cpu() for t in state)))
    for name in ("v", "xs", "xl", "dt"):
        torch.testing.assert_close(getattr(out, name).cpu(), getattr(ref, name), **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_stoch_shard_kernel_equals_plain(cuda, n_shards, matmul_dtype):
    from odesat_tpu_torch.ops import stoch_chunk as sc

    fa = _sharded(n_shards, widths=(1, 2, 5))
    rng = np.random.default_rng(5)
    B, ml = 300, fa.shard_plan.mp_local
    v = torch.as_tensor(rng.random((B, fa.n_vars_padded)) < 0.5, device=cuda)
    active = torch.as_tensor(rng.random(B) < 0.8, device=cuda)
    for s in range(n_shards):
        xl = torch.as_tensor(rng.integers(1, 3001, (B, ml)).astype(np.int32), device=cuda)
        ev = sc.make_stoch_shard_eval(fa, cuda, s, matmul_dtype)
        before = sc.shard_launches
        outs = [ev(v, xl, active) for _ in range(2)]
        ref = sc.stoch_shard_eval_plain(v, xl, active, ev.spec, matmul_dtype == "bfloat16")
        torch.cuda.synchronize()
        assert sc.shard_launches == before + 2
        for a, b, c in zip(outs[0], outs[1], ref):
            assert torch.equal(a, c) and torch.equal(a, b)


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card(cuda):
    from odesat_tpu_torch.parallel import launch

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        launch.spawn(launch.probe, 1, n + 1, "nccl", "cuda", timeout_s=60)


def _chunk_buffers(fa, B, fixed, seed, device, shard=0):
    """Random B6 buffers for one shard: a state with some rows done and a
    reduced acc whose sat count is 0 on some rows."""
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
        b = b._replace(acc2=put(rng.uniform(-2, 2, (B, Np))), err=put(rng.uniform(0, 1e-2, B)),
                       dxs1=put(rng.uniform(-1, 1, (B, ml))), dxl1=put(rng.uniform(-1, 1, (B, ml))))
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_shard_chunk_kernel_equals_plain(cuda, n_shards, mode, rigidity, matmul_dtype):
    """B6 in every phase of its integrator, with and without the apply
    prologue, equals its plain version bit for bit on every shard; the
    launch counter moves once a launch."""
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
            b = _chunk_buffers(fa, 37, fixed, seed=10 * s + i, device=cuda)
            ref = sch.shard_chunk_plain(phase, b, spec, apply)
            before = sch.launches
            out = sch.shard_chunk_cuda(phase, sch.ChunkBuffers(
                *(t.clone() if t is not None else None for t in b)), spec, apply)
            torch.cuda.synchronize()
            assert sch.launches == before + 1
            for name, a, c in zip(b._fields, out, ref):
                assert (a is None and c is None) or torch.equal(a, c), (phase, apply, name)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_shard_chunk_runner_equals_b5_runner(cuda, mode):
    """The chunk through B6 equals the per-step path through B5 bit for
    bit, with the launch counts of its schedule."""
    from odesat_tpu_torch.ops import shard_chunk as sch
    from odesat_tpu_torch.ops import shard_stream as ss

    fa = _sharded(1, widths=(3,))
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None)
    state = _state(fa, 16, 1, cuda)
    state = state._replace(done=torch.arange(16, device=cuda) % 5 == 0)
    before = sch.launches
    out = sch.make_shard_chunk(fa, 0.05, ode, 8, None, cuda)(state)
    torch.cuda.synchronize()
    assert sch.launches == before + (9 if mode == "fixed" else 17)
    ref = ss.make_single_device_runner(fa, 0.05, ode, 8, cuda)(state)
    for name, a, b in zip(state._fields, out, ref):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_stoch_shard_chunk_kernel_equals_plain(cuda, n_shards, matmul_dtype):
    """B9 with and without the flip prologue, and the flip-only launch,
    equals its plain version exactly on every shard."""
    from odesat_tpu_torch.ops import stoch_chunk as sc

    fa = _sharded(n_shards, widths=(1, 2, 5))
    rng = np.random.default_rng(7)
    B, ml, Np = 300, fa.shard_plan.mp_local, fa.n_vars_padded
    bf16 = matmul_dtype == "bfloat16"
    for s in range(n_shards):
        spec = sc.stoch_shard_spec(fa, cuda, s)
        for apply, evaluate in ((False, True), (True, True), (True, False)):
            v = torch.as_tensor(rng.random((B, Np)) < 0.5, device=cuda)
            xl = torch.as_tensor(rng.integers(1, 3001, (B, ml)).astype(np.int32), device=cuda)
            done = torch.as_tensor(rng.random(B) < 0.2, device=cuda)
            acc = rng.integers(0, 40, (B, 2 * Np + 1)).astype(np.float32)
            acc[:, Np:2 * Np] = np.minimum(acc[:, Np:2 * Np], acc[:, :Np])
            acc[:, 2 * Np] = rng.integers(0, 2, B)
            acc = torch.as_tensor(acc, device=cuda)
            args = (spec, bf16, 12345, sc.traj_block(B), 3, apply, evaluate)
            ref = sc.stoch_shard_step_plain(v, xl, done, acc, *args)
            before = sc.shard_chunk_launches
            out = sc.stoch_shard_step_cuda(v.clone(), xl.clone(), done.clone(), acc.clone(),
                                           *args)
            torch.cuda.synchronize()
            assert sc.shard_chunk_launches == before + 1
            for a, c in zip(out, ref):
                assert torch.equal(a, c), (apply, evaluate)


@pytest.mark.cuda
def test_stoch_shard_chunk_runner_equals_b8_path(cuda):
    """The stoch clause path through B9 flips as the path through B8 does."""
    from odesat_tpu_torch.parallel import sharded

    fa = _sharded(1, widths=(3,))
    a = sharded.run_stoch_clause(None, cuda, fa, 3, 9, 4, "float32", 64, "auto")
    b = sharded.run_stoch_clause(None, cuda, fa, 3, 9, 4, "float32", 64, "off")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
