"""The port's integrators and chunked host loop against the JAX package:
``make_step_fn`` over N steps (fixed, adaptive, batch-shared dt) from the
same NumPy state, the multi-chunk runner's exact step accounting, and
``device_dispatch_plan`` / ``drive_chunks`` arithmetic.

Tolerances: float64 to rtol 1e-9 / atol 1e-12 after 30 steps (per-step
agreement is 1e-12, see test_torch_rhs.py; the clamped dynamics carry it
forward); float32 to the fused-kernel tolerance of the JAX tests, rtol
2e-4 / atol 2e-5.
"""

import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables  # noqa: E402
from odesat_tpu.models import loop as jloop  # noqa: E402
from odesat_tpu.models import ode as jode  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.config import SolverConfig as JSC  # noqa: E402
from odesat_tpu_torch.interop import state_from_numpy  # noqa: E402
from odesat_tpu_torch.models import loop as tloop  # noqa: E402
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
from tests.conftest import random_formula  # noqa: E402
from tests.torch_parity import assert_states_close, jax_state, numpy_state  # noqa: E402

TOL = {"float64": dict(rtol=1e-9, atol=1e-12), "float32": dict(rtol=2e-4, atol=2e-5)}


def _fixture(seed, dtype):
    rng = np.random.default_rng(seed)
    formula = random_formula(rng, 10, 25, max_width=3, min_width=2)
    _, normalized = normalize_cnf_variables(formula)
    return compile_formula(normalized, dtype=dtype, clause_pad=8, var_pad=8)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize(
    "mode", ["fixed", "adaptive", "adaptive-shared", "fixed-reference"]
)
def test_step_fn_matches_jax_over_n_steps(dtype, mode):
    np_dtype = np.float64 if dtype == "float64" else np.float32
    fa = _fixture(11, np_dtype)
    kw = dict(
        step_size=0.05 if mode.startswith("fixed") else None,
        tolerance=1e-3,
        dtype=dtype,
        rigidity="reference" if mode.endswith("reference") else "paper",
        dt_mode="shared" if mode.endswith("shared") else "per-trajectory",
    )
    zeta, steps = 0.01, 30
    arrays = numpy_state(fa, 6, seed=3, dtype=np_dtype)

    jstep = jode.make_step_fn(fa, zeta, JODE(**kw))
    jdev = jode.formula_device(fa, dtype=np_dtype)
    jst = jax_state(arrays)
    for _ in range(steps):
        jst = jstep(jst, jdev)

    ode = ODEConfig(**kw)
    tstep = tode.make_step_fn(fa, zeta, ode)
    tdev = tode.formula_device(fa, "cpu", tode.state_dtype(ode))
    tst = state_from_numpy(*arrays, device="cpu")
    for _ in range(steps):
        tst = tstep(tst, tdev)

    assert tst.v.dtype == (torch.float64 if dtype == "float64" else torch.float32)
    assert_states_close(tst, jst, dt_rtol=TOL[dtype]["rtol"], **TOL[dtype])
    if mode == "adaptive-shared":
        assert torch.all(tst.dt == tst.dt[0])


def test_done_trajectory_freezes_after_detecting_step():
    from odesat_tpu_torch.cnf.formula import CNFFormula, Literal
    from odesat_tpu_torch.cnf import compile_formula as tcompile

    fa = tcompile(CNFFormula([(Literal(0), Literal(1))], 2), dtype=np.float64,
                  clause_pad=8, var_pad=8)
    v0 = np.zeros(fa.n_vars_padded)
    v0[:2] = [1.0, 1.0]  # clause value 0 => allsat on the first step
    ode = ODEConfig(step_size=0.05, dtype="float64")
    state = tode.init_state(fa, 1, None, ode, "cpu", v0=v0)
    step = tode.make_step_fn(fa, 0.001, ode)
    dev = tode.formula_device(fa, "cpu", torch.float64)
    first = step(state, dev)
    assert bool(first.done[0])
    later = first
    for _ in range(5):
        later = step(later, dev)
    assert torch.equal(later.v, first.v) and torch.equal(later.xs, first.xs)


@pytest.mark.parametrize("stop_on", ["any", "all"])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_multi_chunk_runner_matches_jax(data_dir, stop_on, mode):
    """Same state in, same state and the same exact steps_advanced out."""
    import os

    from odesat_tpu.cnf import parse_dimacs_file

    _, normalized = normalize_cnf_variables(parse_dimacs_file(os.path.join(data_dir, "small.cnf")))
    fa = compile_formula(normalized, dtype=np.float64, clause_pad=8, var_pad=8)
    kw = dict(step_size=0.05 if mode == "fixed" else None, dtype="float64", dv_strategy="gather")
    arrays = numpy_state(fa, 4, seed=1, dtype=np.float64)
    jrun = jode.make_multi_chunk_runner(fa, 0.01, JODE(**kw), 16, 40, stop_on=stop_on)
    jst, jsteps = jrun(jax_state(arrays), jode.formula_device(fa, dtype=np.float64))
    ode = ODEConfig(**kw)
    trun = tode.make_multi_chunk_runner(fa, 0.01, ode, 16, 40, "cpu", stop_on=stop_on)
    tst, tsteps = trun(state_from_numpy(*arrays, device="cpu"),
                       tode.formula_device(fa, "cpu", torch.float64))
    assert tsteps == int(jsteps) and 0 < tsteps < 16 * 40
    assert_states_close(tst, jst, dt_rtol=1e-9, **TOL["float64"])


PLAN_CASES = [
    dict(batch_size=16384, chunk_steps=256, steps=16384),
    dict(batch_size=4096, chunk_steps=256, steps=20000),
    dict(batch_size=8, chunk_steps=128, steps=None),
    dict(batch_size=1000, chunk_steps=500, steps=300),
    dict(batch_size=7, chunk_steps=64, steps=5000, log_every_chunks=3),
    dict(batch_size=64, chunk_steps=32, steps=None, wall_clock_budget_s=100.0),
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_device_dispatch_plan_matches_jax(case):
    case = dict(case)
    steps = case.pop("steps")
    t = tloop.device_dispatch_plan(SolverConfig(**case), steps)
    j = jloop.device_dispatch_plan(JSC(**case), steps)
    assert t == j


class _Counting(NamedTuple):
    steps: object
    done: object


def _drive(pkg, case, solve_at):
    """Drive a fake state through ``pkg``'s drive_chunks; every runner
    advances a step counter and latches done once it reaches
    ``solve_at``. Returns (steps_run, runner lengths requested)."""
    case = dict(case)
    budget = case.pop("steps")
    asked = []
    if pkg == "torch":
        config, drive = SolverConfig(**case), tloop.drive_chunks
        wrap = torch.as_tensor
    else:
        config, drive = JSC(**case), jloop.drive_chunks
        wrap = jnp.asarray

    def make_runner(n):
        asked.append(n)

        def run(st):
            total = int(st.steps) + n
            return _Counting(total, wrap(np.array([solve_at is not None and total >= solve_at])))

        return run

    def should_stop(st, done):
        return bool(done.any())

    state = _Counting(0, wrap(np.array([False])))
    state, steps_run, _ = drive(state, make_runner, config, budget=budget, should_stop=should_stop)
    return steps_run, asked


@pytest.mark.parametrize(
    "case,solve_at",
    # an unbounded run that never solves does not end, so it is left out
    [(c, s) for c in PLAN_CASES[:5] for s in (None, 700, 40000) if c["steps"] or s],
)
def test_drive_chunks_budget_tail_and_escalation_match_jax(case, solve_at):
    assert _drive("torch", case, solve_at) == _drive("jax", case, solve_at)


def test_simulate_batch_runs_checkpoint_resume_and_profile_options(tmp_path):
    """The options the port once refused run: a snapshot path with a
    cadence writes the state, a resume continues it to the budget, and a
    profile directory receives a chrome trace of the whole solve, the
    formula's compile included."""
    import json

    from odesat_tpu_torch.interop import formula_arrays_from_numpy

    fa = formula_arrays_from_numpy(_fixture(0, np.float32))
    path, prof = str(tmp_path / "x.npz"), str(tmp_path / "p")
    config = SolverConfig(ode=ODEConfig(step_size=0.05, steps=16), batch_size=2, seed=0,
                          chunk_steps=8, checkpoint_path=path, checkpoint_every_chunks=1)
    assert tode.simulate_batch(fa, config, device="cpu").steps == 16
    resumed = SolverConfig(ode=ODEConfig(step_size=0.05, steps=24), batch_size=2, seed=0,
                           chunk_steps=8, resume_from=path, profile_dir=prof)
    assert tode.simulate_batch(fa, resumed, device="cpu").steps == 24
    with open(os.path.join(prof, "trace_rank0.json"), encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"ode.solve", "ode.compile", "loop.decide", "ode.readout"} <= names
    # a mesh runs too; forcing the clause-sharded chunk kernel (B6) on a
    # formula without a clause-shard plan is refused before any collective
    from types import SimpleNamespace

    from odesat_tpu_torch.parallel.sharded import make_sharded_chunk_runner

    with pytest.raises(ValueError, match="shard_chunk='on' needs a clause-shard plan"):
        make_sharded_chunk_runner(fa, 0.05, ODEConfig(shard_chunk="on"), 8,
                                  SimpleNamespace(n_traj=1, n_clause=2), "cpu")


def test_auto_ladder_takes_the_kernel_only_on_cuda():
    fa = _fixture(0, np.float32)
    ode = ODEConfig(step_size=0.01)
    assert tode.resolve_strategy(fa, ode, "cpu") == "gather"
    assert tode.resolve_strategy(fa, ode, "cuda") == "fused"
    assert tode.resolve_strategy(fa, ODEConfig(step_size=0.01, dtype="float64"), "cuda") == "gather"
    assert tode.resolve_strategy(fa, ODEConfig(dt_mode="shared"), "cuda") == "gather"
    assert tode.resolve_strategy(fa, ODEConfig(dt_mode="shared", step_size=0.01), "cuda") == "fused"
    unit = compile_formula(
        normalize_cnf_variables(random_formula(np.random.default_rng(1), 8, 20, 3, 1))[1]
    )
    assert unit.min_width == 1
    assert tode.resolve_strategy(unit, ode, "cuda") == "gather"
