"""The port's library entry point, ``simulate_batch``, on the CPU: it
solves small.cnf and easy.cnf from a NumPy initial state with the oracle
check passing, and after a short fixed budget its final state matches the
JAX package's ``simulate_batch`` from the same ``v0``.

Tolerance of the final-state comparison: float64, rtol 1e-9 / atol 1e-12
(per-step agreement is 1e-12, test_torch_rhs.py).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.cnf import parse_dimacs_file as jparse  # noqa: E402
from odesat_tpu.models.ode import simulate_batch as jax_simulate_batch  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.config import SolverConfig as JSC  # noqa: E402
from odesat_tpu_torch.cnf import (  # noqa: E402
    compile_formula,
    evaluate_cnf,
    map_values_by_indices,
    normalize_cnf_variables,
    parse_dimacs_file,
)
from odesat_tpu_torch.models.ode import simulate, simulate_batch  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
from tests.torch_parity import assert_states_close  # noqa: E402


def _v0(fa, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=fa.n_vars_padded)


@pytest.mark.parametrize(
    "name,ode",
    [
        ("small", dict(step_size=0.01, steps=2000)),
        ("easy", dict(step_size=0.05, steps=6000)),
        ("easy", dict(steps=6000)),  # adaptive
    ],
)
def test_simulate_batch_solves_from_numpy_v0(data_dir, name, ode):
    formula = parse_dimacs_file(os.path.join(data_dir, f"{name}.cnf"))
    mapping, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized)
    config = SolverConfig(ode=ODEConfig(**ode), batch_size=2, chunk_steps=128)
    result = simulate_batch(normalized, config, device="cpu", v0=_v0(fa, 1))
    assert result.any_solved, f"{name}.cnf unsolved after {result.steps} steps"
    assert result.steps < ode["steps"]
    mapped = map_values_by_indices(mapping, result.best_assignment())
    assert evaluate_cnf(mapped, formula)


def test_simulate_single_trajectory(data_dir):
    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    mapping, normalized = normalize_cnf_variables(formula)
    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=2000), seed=0)
    bits = simulate(normalized, config, device="cpu")
    assert bits.shape == (normalized.varnum,)
    assert evaluate_cnf(map_values_by_indices(mapping, bits), formula)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_final_state_matches_jax_simulate_batch(data_dir, mode):
    """Both packages' chunk loops run the same schedule; a harvest hook
    that never stops captures each one's state after the last chunk."""
    path = os.path.join(data_dir, "hard.cnf")  # UNSAT: runs its whole budget
    kw = dict(step_size=0.01 if mode == "fixed" else None, steps=300, dtype="float64",
              dv_strategy="gather")
    common = dict(batch_size=3, chunk_steps=64, seed=0)
    _, tnorm = normalize_cnf_variables(parse_dimacs_file(path))
    v0 = _v0(compile_formula(tnorm), 7)

    captured = {}

    def keep(pkg):
        def harvest(state, done):
            captured[pkg] = state
            return False

        return harvest

    tres = simulate_batch(tnorm, SolverConfig(ode=ODEConfig(**kw), **common), device="cpu",
                          v0=v0, harvest=keep("torch"))
    _, jnorm = jnormalize(jparse(path))
    jres = jax_simulate_batch(jnorm, JSC(ode=JODE(**kw), **common), v0=v0, harvest=keep("jax"))

    assert tres.steps == jres.steps == 300
    np.testing.assert_array_equal(tres.done, jres.done)
    np.testing.assert_array_equal(tres.assignment, jres.assignment)
    assert captured["torch"].v.dtype == torch.float64
    assert_states_close(captured["torch"], captured["jax"], rtol=1e-9, atol=1e-12, dt_rtol=1e-9)
