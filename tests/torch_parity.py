"""Helpers shared by the ``test_torch_*`` parity tests: carry a formula
and an explicit NumPy initial state into both packages.

The two packages' RNGs differ, so every comparison starts from arrays
drawn here with NumPy from a seed. torch runs with two threads so the
pytest-xdist workers do not oversubscribe the CPU.
"""

import numpy as np
import torch

from odesat_tpu_torch.cnf.formula import CNFFormula, Literal
from odesat_tpu_torch.interop import state_to_numpy

torch.set_num_threads(2)


def port_formula(formula) -> CNFFormula:
    """The port's CNFFormula with the clauses of a JAX-package formula."""
    return CNFFormula(
        [tuple(Literal(lit.variable, lit.is_negated) for lit in c) for c in formula.clauses],
        formula.varnum,
    )


def numpy_state(fa, B, seed, dtype=np.float32, dt0=0.01):
    """(v, xs, xl, dt, done) as NumPy arrays: v ~ U(-1, 1) from ``seed``,
    xs from the formula's all-false valuation, xl = 1, dt = dt0."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, size=(B, fa.n_vars_padded)).astype(dtype)
    xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(dtype).copy()
    xl = np.ones((B, fa.n_clauses_padded), dtype=dtype)
    dt = np.full((B,), dt0, dtype=dtype)
    done = np.zeros((B,), dtype=bool)
    return v, xs, xl, dt, done


def jax_state(arrays):
    """The JAX package's ODEState from NumPy arrays (dtypes kept)."""
    import jax.numpy as jnp

    from odesat_tpu.models.ode import ODEState

    return ODEState(*(jnp.asarray(a) for a in arrays))


def to_numpy(state):
    """Any ODEState (either package) as a tuple of NumPy arrays."""
    if isinstance(state.v, torch.Tensor):
        return tuple(state_to_numpy(state))
    return tuple(np.asarray(t) for t in state)


def assert_states_close(a, b, rtol, atol, dt_rtol=None):
    """v, xs, xl within (rtol, atol); done exactly; dt within dt_rtol
    when given."""
    a, b = to_numpy(a), to_numpy(b)
    for name, x, y in zip(("v", "xs", "xl"), a[:3], b[:3]):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_array_equal(a[4], b[4], err_msg="done")
    if dt_rtol is not None:
        np.testing.assert_allclose(a[3], b[3], rtol=dt_rtol, err_msg="dt")
