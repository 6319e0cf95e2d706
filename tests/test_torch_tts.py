"""The port's exact time-to-solution protocol (``odesat_tpu_torch/utils/tts.py``)
against the JAX package's, the cases of tests/test_tts.py.

* In float64 through the twin, the port's ``solve_exact`` finds the very
  step JAX's finds from the same initial state (both packages' init
  functions monkeypatched to hand out one NumPy state), with the same
  chunk count and first solved row.
* In float32 it equals the port's own single-step replay (chunk 1 runners
  from the same state), chunk-granular and within the first chunk.
* Budget exhaustion, readout against ``simulate_batch``, the runner cache
  keyed by formula identity and its eviction, the power-of-two ladder and
  the breakdown arithmetic, as in the JAX tests.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.cnf import parse_dimacs_file as jparse  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu_torch.cnf import CNFFormula, Literal, compile_formula  # noqa: E402
from odesat_tpu_torch.cnf import normalize_cnf_variables, parse_dimacs_file  # noqa: E402
from odesat_tpu_torch.interop import state_from_numpy  # noqa: E402
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.utils import timing  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
from odesat_tpu_torch.utils.tts import (  # noqa: E402
    _pow2_ladder,
    evict_formula,
    measure_dispatch_latency,
    solve_exact,
    tts_breakdown,
)
from tests.torch_parity import jax_state, numpy_state  # noqa: E402


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _fa(data_dir, name="easy.cnf"):
    norm = normalize_cnf_variables(parse_dimacs_file(os.path.join(data_dir, name)))[1]
    return compile_formula(norm), norm


def _replay_steps(fa, ode, batch, generator, budget):
    """First step at which done.any(), by single-step replay."""
    runner = tode.make_chunk_runner(fa, ode.resolve_zeta(fa.density), ode, 1, "cpu")
    dev = tode.formula_device(fa, "cpu", tode.state_dtype(ode))
    state = tode.init_state(fa, batch, generator, ode, "cpu")
    for step in range(1, budget + 1):
        state = runner(state, dev)
        if state.done.any():
            return step
    return None


@pytest.mark.parametrize("chunk", [64, 48])  # power of two and not
def test_exact_step_equals_jax_from_the_same_state(data_dir, monkeypatch, chunk):
    """float64, fixed dt: both packages start from one NumPy state; JAX's
    solve_exact (host-paced: the scan path has no device loop) and the
    port's find the same step, chunk count and first solved row."""
    from odesat_tpu.models import ode as jode
    from odesat_tpu.utils.tts import solve_exact as jsolve_exact

    jfa = jcompile(jnormalize(jparse(os.path.join(data_dir, "easy.cnf")))[1],
                   dtype=np.float64)
    fa, _ = _fa(data_dir)
    arrays = numpy_state(fa, 8, seed=3, dtype=np.float64)
    monkeypatch.setattr(jode, "init_state", lambda *a, **k: jax_state(arrays))
    monkeypatch.setattr(tode, "init_state", lambda *a, **k: state_from_numpy(*arrays,
                                                                              device="cpu"))
    want = jsolve_exact(jfa, JODE(step_size=0.05, dtype="float64"), 8, None, chunk, 1024)
    got = solve_exact(fa, ODEConfig(step_size=0.05, dtype="float64"), 8, None, chunk, 1024,
                      device="cpu")
    assert want.solved and got.solved
    assert (got.steps, got.chunks, got.solved_index) == (want.steps, want.chunks,
                                                         want.solved_index)


@pytest.mark.parametrize("chunk", [64, 48, 1024])
def test_exact_step_equals_the_single_step_replay(data_dir, chunk):
    """float32: the bisected step is the replay's, and the chunk count the
    solve's own (probes excluded); a chunk of 1024 holds the whole solve."""
    fa, _ = _fa(data_dir)
    ode = ODEConfig(step_size=0.05)
    truth = _replay_steps(fa, ode, 8, _gen(3), 1024)
    assert truth is not None, "the fixture must solve within the test budget"
    res = solve_exact(fa, ode, 8, _gen(3), chunk, 1024, device="cpu")
    assert res.solved and res.steps == truth
    assert res.chunks == -(-truth // chunk)


def test_unsolved_returns_budget(data_dir):
    fa, _ = _fa(data_dir)
    res = solve_exact(fa, ODEConfig(step_size=1e-6), 4, _gen(0), 16, budget=48, device="cpu")
    assert not res.solved and res.steps == 48 and res.chunks == 3


def test_unsat_budget_tail_runs(data_dir):
    """An UNSAT formula through the kernels' plain version (forced fused):
    the whole budget, the 8-step tail included, in one dispatch of three
    chunks and the host-paced tail (JAX tests/test_tts.py's
    test_exact_steps_device_path_budget_exhaustion counts the same 2)."""
    def pair(a, b):
        return (Literal(0, a), Literal(1, b))

    unsat = CNFFormula([pair(False, False), pair(False, True), pair(True, False),
                        pair(True, True)], 2)
    res = solve_exact(compile_formula(unsat), ODEConfig(step_size=0.05, dv_strategy="fused"),
                      8, _gen(0), 64, 200, device="cpu")
    assert not res.solved and res.steps == 200 and res.chunks == 2


def test_readout_matches_production_path(data_dir, monkeypatch):
    """The bisection readout equals simulate_batch's frozen row for the same
    trajectory (the done latch freezes v, so chunk boundaries do not
    matter)."""
    fa, norm = _fa(data_dir)
    ode = ODEConfig(step_size=0.05)
    res = solve_exact(fa, ode, 8, _gen(3), 64, 1024, readout=True, device="cpu")
    assert res.solved and res.assignment is not None
    sim = tode.simulate_batch(fa, SolverConfig(ode=ODEConfig(step_size=0.05, steps=1024),
                                               batch_size=8, chunk_steps=64),
                              device="cpu", generator=_gen(3))
    assert sim.done[res.solved_index]
    np.testing.assert_array_equal(res.assignment, sim.assignment[res.solved_index])


def test_runner_cache_shared_and_keyed_by_formula(data_dir):
    """A shared cache: the same instance again builds nothing; a same-shaped
    but different formula is solved against its own tables (the fused
    kernel's plain version holds them), so an UNSAT one does not latch."""
    fa, _ = _fa(data_dir)
    ode = ODEConfig(step_size=0.05)
    cache: dict = {}
    r1 = solve_exact(fa, ode, 8, _gen(3), 64, 1024, runner_cache=cache, device="cpu")
    n = len(cache)
    r2 = solve_exact(fa, ode, 8, _gen(3), 64, 1024, runner_cache=cache, device="cpu")
    assert r1.steps == r2.steps and len(cache) == n

    def pair(a, b):
        return (Literal(0, a), Literal(1, b))

    sat = CNFFormula([pair(False, False)] * 4, 2)
    unsat = CNFFormula([pair(False, False), pair(False, True), pair(True, False),
                        pair(True, True)], 2)
    fused = ODEConfig(step_size=0.05, dv_strategy="fused")
    shared: dict = {}
    assert solve_exact(compile_formula(sat), fused, 8, _gen(1), 32, 512, runner_cache=shared,
                       device="cpu").solved
    assert not solve_exact(compile_formula(unsat), fused, 8, _gen(1), 32, 512,
                           runner_cache=shared, device="cpu").solved


def test_evict_formula_drops_only_that_instance(data_dir):
    fa1, _ = _fa(data_dir)
    fa2, _ = _fa(data_dir, "small.cnf")
    ode = ODEConfig(step_size=0.05)
    cache: dict = {}
    solve_exact(fa1, ode, 8, _gen(3), 64, 1024, runner_cache=cache, device="cpu")
    solve_exact(fa2, ode, 8, _gen(3), 64, 1024, runner_cache=cache, device="cpu")
    assert {k[0] for k in cache} == {id(fa1), id(fa2)}
    n2 = sum(1 for k in cache if k[0] == id(fa2))
    evict_formula(cache, fa1)
    assert {k[0] for k in cache} == {id(fa2)}
    assert sum(1 for k in cache if k[0] == id(fa2)) == n2
    evict_formula(cache, fa2)
    assert not cache


def test_pow2_ladder_and_breakdown_equal_jax():
    from odesat_tpu.utils.tts import _pow2_ladder as jladder
    from odesat_tpu.utils.tts import tts_breakdown as jbreakdown

    for chunk in (1, 2, 3, 48, 64, 100):
        sizes = _pow2_ladder(chunk)
        assert sizes == jladder(chunk)
        reachable = {0}
        for s in sizes:
            reachable |= {r + s for r in reachable}
        assert set(range(chunk)) <= reachable
    args = dict(steps=100, chunks=2, batch=10, kernel_rate=1000.0, dispatch_s=0.01, wall_s=1.5)
    bd = tts_breakdown(**args)
    assert bd == jbreakdown(**args)
    assert bd["compute_s"] == pytest.approx(1.0) and bd["residual_s"] == pytest.approx(0.48)


def test_timing_helpers_on_the_cpu(data_dir):
    """sync reads the done flags; measure_throughput counts B x steps x
    iters over the timed calls; the dispatch latency is a positive time."""
    fa, _ = _fa(data_dir)
    ode = ODEConfig(step_size=0.05)
    runner = tode.make_chunk_runner(fa, ode.resolve_zeta(fa.density), ode, 4, "cpu")
    state = tode.init_state(fa, 2, _gen(0), ode, "cpu")
    dev = tode.formula_device(fa, "cpu")
    np.testing.assert_array_equal(timing.sync(state), np.zeros(2, bool))
    rate, out = timing.measure_throughput(runner, state, dev, 4, 2, iters=2)
    assert rate > 0 and out.v.shape == state.v.shape
    assert measure_dispatch_latency(3, device="cpu") > 0
