"""The multi-chunk loop's stop rule and ``solve_exact``'s one-dispatch path
against the JAX package, on the CPU.

JAX runs its multi-chunk loop as a ``lax.while_loop`` whose ``cond`` tests
the done flags before each chunk (odesat_tpu/models/ode.py:469-478,
stoch.py:293-302, parallel/sharded.py:389-397): a state already stopped at
entry runs no chunk. The port's host loop (``models/loop.run_chunks``), the
plain version of its device loop (``ops/device_loop.py``, a CUDA graph that
runs only on the card: tests/test_torch_cuda.py), follows the same rule:

* an entry state with a done row (every row done, for ``stop_on="all"``):
  the ODE, stoch and trajectory-mesh runners of both packages advance 0
  steps and return the state unchanged; with one row done and
  ``stop_on="all"`` both run their chunks;
* a stop that lands in chunk k > 1 of a dispatch: the same
  ``steps_advanced`` as JAX's, the state within the parity tolerances
  (float64 through the twin: rtol 1e-9 / atol 1e-12; float32 through B1's
  plain version against JAX's fused kernel in interpret mode: rtol 2e-4 /
  atol 2e-5; done exactly);
* ``drive_chunks`` ends its loop after a dispatch that advanced 0 steps;
* ``solve_exact``'s one-dispatch path, through B1's plain version
  (``dv_strategy="fused"``): the exact step of JAX's ``solve_exact`` from
  the same initial state, and of the port's own host-paced path, with the
  dispatch counted as one chunk.

Every input comes from a NumPy seed and goes to both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.cnf import parse_dimacs_file as jparse  # noqa: E402
from odesat_tpu.models import ode as jode  # noqa: E402
from odesat_tpu.models import stoch as jstoch  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu_torch.interop import (  # noqa: E402
    formula_arrays_from_numpy,
    state_from_numpy,
    stoch_state_from_numpy,
)
from odesat_tpu_torch.models import loop as tloop  # noqa: E402
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.models import stoch as tstoch  # noqa: E402
from odesat_tpu_torch.parallel import launch, sharded  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
from odesat_tpu_torch.utils.tts import solve_exact  # noqa: E402
from tests.torch_parity import assert_states_close, jax_state, numpy_state, to_numpy  # noqa: E402

F64 = dict(rtol=1e-9, atol=1e-12)
F32 = dict(rtol=2e-4, atol=2e-5)
INNER, MAX_CHUNKS = 8, 4


def _jfa(data_dir, name, dtype=np.float64, **kw):
    return jcompile(jnormalize(jparse(os.path.join(data_dir, name)))[1], dtype=dtype, **kw)


def _entry(fa, B, done_rows, dtype=np.float64, seed=1):
    """A NumPy state whose ``done_rows`` are set at entry."""
    v, xs, xl, dt, done = numpy_state(fa, B, seed=seed, dtype=dtype)
    done[list(done_rows)] = True
    return v, xs, xl, dt, done


def _assert_unchanged(out, arrays):
    for name, a, b in zip(("v", "xs", "xl", "dt", "done"), to_numpy(out), arrays):
        np.testing.assert_array_equal(a, b, err_msg=name)


# ------------------------------------------------------------------ ODE


@pytest.mark.parametrize("stop_on", ["any", "all"])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_ode_runner_stopped_at_entry_runs_no_chunk(data_dir, stop_on, mode):
    """small.cnf, B=4, float64: row 0 done ("any") or every row done
    ("all") at entry; JAX's while loop and the port's runner advance 0
    steps and hand the state back unchanged."""
    fa = _jfa(data_dir, "small.cnf", clause_pad=8, var_pad=8)
    arrays = _entry(fa, 4, [0] if stop_on == "any" else range(4))
    kw = dict(step_size=0.01 if mode == "fixed" else None, dtype="float64",
              dv_strategy="gather")
    jrun = jode.make_multi_chunk_runner(fa, 0.01, JODE(**kw), INNER, MAX_CHUNKS, stop_on=stop_on)
    jst, jsteps = jrun(jax_state(arrays), jode.formula_device(fa, dtype=np.float64))
    trun = tode.make_multi_chunk_runner(fa, 0.01, ODEConfig(**kw), INNER, MAX_CHUNKS, "cpu",
                                        stop_on=stop_on)
    tst, tsteps = trun(state_from_numpy(*arrays, device="cpu"),
                       tode.formula_device(fa, "cpu", torch.float64))
    assert int(jsteps) == 0 and tsteps == 0
    _assert_unchanged(jst, arrays)
    _assert_unchanged(tst, arrays)


def test_ode_runner_with_one_row_done_runs_on_under_stop_all(data_dir):
    """One row done is no stop for "all": both packages run every chunk
    (small.cnf solves no further row in 32 steps at dt 0.01)."""
    fa = _jfa(data_dir, "small.cnf", clause_pad=8, var_pad=8)
    arrays = _entry(fa, 4, [0])
    kw = dict(step_size=0.01, dtype="float64", dv_strategy="gather")
    jrun = jode.make_multi_chunk_runner(fa, 0.01, JODE(**kw), INNER, MAX_CHUNKS, stop_on="all")
    jst, jsteps = jrun(jax_state(arrays), jode.formula_device(fa, dtype=np.float64))
    trun = tode.make_multi_chunk_runner(fa, 0.01, ODEConfig(**kw), INNER, MAX_CHUNKS, "cpu",
                                        stop_on="all")
    tst, tsteps = trun(state_from_numpy(*arrays, device="cpu"),
                       tode.formula_device(fa, "cpu", torch.float64))
    assert tsteps == int(jsteps) == INNER * MAX_CHUNKS
    assert_states_close(tst, jst, dt_rtol=1e-9, **F64)


@pytest.mark.parametrize("stop_on", ["any", "all"])
def test_ode_stop_inside_a_dispatch_f64_matches_jax(data_dir, stop_on):
    """easy.cnf, float64 through the twin, fixed dt 0.05, 16-step chunks:
    the stop lands in chunk k > 1 of the dispatch, at JAX's step (B=8 for
    "any", B=2 for "all", whose rows all finish within the dispatch)."""
    fa = _jfa(data_dir, "easy.cnf")
    arrays = numpy_state(fa, 8 if stop_on == "any" else 2, seed=3, dtype=np.float64)
    kw = dict(step_size=0.05, dtype="float64", dv_strategy="gather")
    jrun = jode.make_multi_chunk_runner(fa, 0.01, JODE(**kw), 16, 64, stop_on=stop_on)
    jst, jsteps = jrun(jax_state(arrays), jode.formula_device(fa, dtype=np.float64))
    trun = tode.make_multi_chunk_runner(fa, 0.01, ODEConfig(**kw), 16, 64, "cpu",
                                        stop_on=stop_on)
    tst, tsteps = trun(state_from_numpy(*arrays, device="cpu"),
                       tode.formula_device(fa, "cpu", torch.float64))
    assert tsteps == int(jsteps) and 16 < tsteps < 16 * 64
    assert_states_close(tst, jst, dt_rtol=1e-9, **F64)


def test_b1_plain_stop_inside_a_dispatch_matches_jax_fused(data_dir):
    """float32 through B1's plain version (the port's kernel runner, whose
    multi-chunk runner is the device loop on a card) against JAX's fused
    kernel in interpret mode: the same chunk of the stop."""
    fa = _jfa(data_dir, "easy.cnf", dtype=np.float32)
    arrays = numpy_state(fa, 8, seed=3)
    kw = dict(step_size=0.05, dv_strategy="fused")
    jrun = jode.make_multi_chunk_runner(fa, 0.01, JODE(**kw), 32, 32, stop_on="any")
    jst, jsteps = jrun(jax_state(arrays), jode.formula_device(fa))
    trun = tode.make_multi_chunk_runner(fa, 0.01, ODEConfig(**kw), 32, 32, "cpu")
    tst, tsteps = trun(state_from_numpy(*arrays, device="cpu"))
    assert tsteps == int(jsteps) and 32 < tsteps < 32 * 32
    assert_states_close(tst, jst, dt_rtol=2e-4, **F32)


@pytest.mark.parametrize("stop_on", ["any", "all"])
def test_drive_chunks_ends_after_a_dispatch_of_zero_steps(data_dir, stop_on):
    """simulate_batch resumed from a state that its stop rule already
    holds: one dispatch of 0 steps, then the loop ends (it would spin
    otherwise)."""
    fa = formula_arrays_from_numpy(_jfa(data_dir, "small.cnf", dtype=np.float32))
    arrays = _entry(fa, 4, [1] if stop_on == "any" else range(4), dtype=np.float32)
    calls = []

    def runner_factory(n):
        multi = tode.make_multi_chunk_runner(fa, 0.01, ODEConfig(step_size=0.01), 16, n // 16,
                                             "cpu", stop_on=stop_on)

        def run(st):
            calls.append(n)
            return multi(st)

        return run

    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=4096), batch_size=4,
                          chunk_steps=64)
    state, steps, _ = tloop.drive_chunks(
        state_from_numpy(*arrays, device="cpu"), runner_factory, config, budget=4096,
        should_stop=lambda st, done: bool(done.any() if stop_on == "any" else done.all()))
    assert steps == 0 and calls == [64]
    _assert_unchanged(state, arrays)


def test_drive_chunks_raises_when_a_dispatch_of_zero_steps_does_not_stop(data_dir):
    """A runner that advances 0 steps from a state its caller's stop rule
    does not hold (a mismatch between the two rules): drive_chunks raises
    instead of spinning."""
    fa = formula_arrays_from_numpy(_jfa(data_dir, "small.cnf", dtype=np.float32))
    arrays = _entry(fa, 4, [], dtype=np.float32)
    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=4096), batch_size=4,
                          chunk_steps=64)
    with pytest.raises(RuntimeError, match="advanced 0 steps"):
        tloop.drive_chunks(state_from_numpy(*arrays, device="cpu"),
                           lambda n: (lambda st: (st, 0)), config, budget=4096,
                           should_stop=lambda st, done: False)


# ---------------------------------------------------------------- stoch


def test_stoch_runner_stopped_at_entry_runs_no_chunk(data_dir):
    """hard.cnf, B=8, a chain done at entry: JAX's stoch while loop (B3 in
    interpret mode) and the port's multi runner (B3's plain version)
    advance 0 steps, leave the state as it was and, in the port, draw no
    seed from the generator."""
    fa = _jfa(data_dir, "hard.cnf", dtype=np.float32)
    tfa = formula_arrays_from_numpy(fa)
    rng = np.random.default_rng(5)
    v = rng.random((8, fa.n_vars_padded)) < 0.5
    xl = rng.integers(1, 50, (8, fa.n_clauses_padded)).astype(np.int32)
    done = np.zeros(8, bool)
    done[3] = True
    jmulti = jstoch.make_multi_stoch_runner(fa, 16, 4, fused="on")
    jst, jsteps = jmulti(jstoch.StochState(jnp.asarray(v), jnp.asarray(xl), jnp.asarray(done),
                                           jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    chunk = tstoch.make_stoch_chunk_runner(tfa, 16, "cpu", gen, fused="on")
    before = gen.get_state()
    tst, tsteps = tstoch.make_multi_stoch_runner(chunk, 16, 4)(
        stoch_state_from_numpy(v, xl, done, "cpu"))
    assert int(jsteps) == 0 and tsteps == 0
    assert torch.equal(gen.get_state(), before)
    for name, want in (("v", v), ("xl", xl), ("done", done)):
        np.testing.assert_array_equal(np.asarray(getattr(jst, name)), want, err_msg=name)
        np.testing.assert_array_equal(getattr(tst, name).numpy(), want, err_msg=name)


def test_stoch_runner_stop_inside_a_dispatch_counts_its_chunks():
    """A planted 3-SAT whose chains solve within a few chunks: the port's
    multi runner stops after the chunk that leaves a chain done, with its
    steps and state those of the same chunks run one by one from the same
    generator."""
    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables
    from odesat_tpu_torch.utils.generate import random_ksat

    fa = compile_formula(normalize_cnf_variables(random_ksat(50, 210, seed=4, planted=True))[1])
    state0 = tstoch.init_stoch_state(fa, 16, "cpu")
    gen = torch.Generator().manual_seed(0)
    multi = tstoch.make_multi_stoch_runner(
        tstoch.make_stoch_chunk_runner(fa, 4, "cpu", gen, fused="on"), 4, 500)
    out, steps = multi(state0)
    ref_gen = torch.Generator().manual_seed(0)
    one = tstoch.make_stoch_chunk_runner(fa, 4, "cpu", ref_gen, fused="on")
    ref, k = state0, 0
    while not bool(ref.done.any()):
        ref, k = one(ref), k + 1
    assert steps == 4 * k and k > 1
    for name in ("v", "xl", "done"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert torch.equal(gen.get_state(), ref_gen.get_state())


# ------------------------------------------------------------ the mesh


@pytest.fixture(scope="module")
def mesh_runs(data_dir):
    """One spawned gloo world of two trajectory ranks: small.cnf B=4 with a
    done row on rank 0 only ("any": every rank stops before its first
    chunk), every row done ("all"), and easy.cnf B=8 with a stop inside the
    dispatch; float64 through the twin."""
    small = formula_arrays_from_numpy(_jfa(data_dir, "small.cnf", clause_pad=8, var_pad=8))
    easy = formula_arrays_from_numpy(_jfa(data_dir, "easy.cnf"))
    fixed = ODEConfig(step_size=0.01, dtype="float64", dv_strategy="gather")
    cases = [
        (small, 0.01, fixed, INNER, MAX_CHUNKS, "any", _entry(small, 4, [0])),
        (small, 0.01, fixed, INNER, MAX_CHUNKS, "all", _entry(small, 4, range(4))),
        (easy, 0.01, ODEConfig(step_size=0.05, dtype="float64", dv_strategy="gather"), 16, 64,
         "any", numpy_state(easy, 8, seed=3, dtype=np.float64)),
    ]
    out = launch.spawn(sharded.run_multi_cases, 2, 1, "gloo", "cpu", timeout_s=180,
                       args=(cases,))
    return cases, out, _jfa(data_dir, "easy.cnf")


@pytest.mark.parametrize("case", [0, 1])
def test_sharded_runner_stopped_at_entry_runs_no_chunk(mesh_runs, case):
    cases, out, _ = mesh_runs
    state, steps = out[case]
    assert steps == 0
    _assert_unchanged(state, cases[case][-1])


def test_sharded_runner_stop_inside_a_dispatch_matches_jax(mesh_runs):
    cases, out, jfa = mesh_runs
    state, steps = out[2]
    arrays = cases[2][-1]
    jrun = jode.make_multi_chunk_runner(
        jfa, 0.01, JODE(step_size=0.05, dtype="float64", dv_strategy="gather"), 16, 64)
    jst, jsteps = jrun(jax_state(arrays), jode.formula_device(jfa, dtype=np.float64))
    assert steps == int(jsteps) and 16 < steps < 16 * 64
    assert_states_close(state, jst, dt_rtol=1e-9, **F64)


# ---------------------------------------------------------- solve_exact


@pytest.mark.parametrize("chunk", [64, 48])
def test_solve_exact_one_dispatch_matches_jax_and_the_host_paced_path(data_dir, monkeypatch,
                                                                      chunk):
    """easy.cnf, B=8, fixed dt 0.05, float32: the port's one-dispatch path
    through B1's plain version finds the step of JAX's solve_exact (its own
    one-dispatch path, the fused kernel in interpret mode) from the same
    NumPy state, and of the port's host-paced path over the same runner;
    the dispatch counts as one chunk."""
    from odesat_tpu.utils.tts import solve_exact as jsolve_exact

    jfa = _jfa(data_dir, "easy.cnf", dtype=np.float32)
    fa = formula_arrays_from_numpy(jfa)
    arrays = numpy_state(jfa, 8, seed=3)
    monkeypatch.setattr(jode, "init_state", lambda *a, **k: jax_state(arrays))
    monkeypatch.setattr(tode, "init_state",
                        lambda *a, **k: state_from_numpy(*arrays, device="cpu"))
    ode = ODEConfig(step_size=0.05, dv_strategy="fused")
    want = jsolve_exact(jfa, JODE(step_size=0.05, dv_strategy="fused"), 8, None, chunk, 1024)
    got = solve_exact(fa, ode, 8, None, chunk, 1024, device="cpu")
    # the same runner without its loop body: solve_exact takes its
    # host-paced path
    build = tode.make_chunk_runner
    monkeypatch.setattr(tode, "make_chunk_runner",
                        lambda *a, **k: (lambda st, dev=None, f=build(*a, **k): f(st, dev)))
    host = solve_exact(fa, ode, 8, None, chunk, 1024, device="cpu")
    assert want.solved and got.solved and host.solved
    assert got.steps == want.steps == host.steps and got.steps > chunk
    assert got.solved_index == want.solved_index == host.solved_index
    assert (got.chunks, want.chunks, host.chunks) == (1, 1, -(-host.steps // chunk))
