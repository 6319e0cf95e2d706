"""The torch twin of the ODE right-hand side (odesat_tpu_torch/ops/rhs.py)
against ``odesat_tpu.ops.rhs.compute_derivatives`` from the same NumPy
state: both dv strategies, both rigidity modes, width buckets, unit
clauses with their infinite gradients, and the NaN clamp.

Tolerances: float64 agrees to 1e-12 (the two packages sum a variable's
contributions in different orders, which moves the last bits only);
float32 to rtol 1e-5 / atol 1e-5 for the same reason at f32 precision.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables  # noqa: E402
from odesat_tpu.cnf.formula import CNFFormula, Literal  # noqa: E402
from odesat_tpu.ops import rhs as jrhs  # noqa: E402
from odesat_tpu_torch.ops import rhs as trhs  # noqa: E402
from tests.conftest import random_formula  # noqa: E402
import tests.torch_parity  # noqa: E402,F401  (thread count)

TOL = {np.float64: dict(rtol=1e-12, atol=1e-12), np.float32: dict(rtol=1e-5, atol=1e-5)}


def _setup(seed, dtype, min_width=1, max_width=4, bucket=False, B=None):
    rng = np.random.default_rng(seed)
    formula = random_formula(rng, 12, 30, max_width, min_width)
    _, normalized = normalize_cnf_variables(formula)
    fa = compile_formula(normalized, dtype=dtype, clause_pad=8, var_pad=8,
                         bucket=bucket, min_bucket=4)
    lead = () if B is None else (B,)
    v = rng.uniform(-1, 1, size=lead + (fa.n_vars_padded,)).astype(dtype)
    xs = rng.uniform(0.001, 0.999, size=lead + (fa.n_clauses_padded,)).astype(dtype)
    xl = rng.uniform(1.0, 50.0, size=lead + (fa.n_clauses_padded,)).astype(dtype)
    return fa, v, xs, xl


def _both(fa, v, xs, xl, zeta, rigidity, dv_strategy, buckets=None):
    dtype = v.dtype
    j = jrhs.compute_derivatives(
        jnp.asarray(v), jnp.asarray(xs), jnp.asarray(xl),
        lit_var=jnp.asarray(fa.lit_var), sign=jnp.asarray(fa.sign, dtype=dtype),
        lit_mask=jnp.asarray(fa.lit_mask, dtype=dtype),
        clause_mask=jnp.asarray(fa.clause_mask, dtype=dtype),
        var_occ=jnp.asarray(fa.var_occ), occ_mask=jnp.asarray(fa.occ_mask, dtype=dtype),
        zeta=zeta, rigidity=rigidity, dv_strategy=dv_strategy, bucket_slices=buckets,
    )
    t = trhs.compute_derivatives(
        torch.as_tensor(v), torch.as_tensor(xs), torch.as_tensor(xl),
        lit_var=torch.as_tensor(fa.lit_var, dtype=torch.int64),
        sign=torch.as_tensor(fa.sign.astype(dtype)),
        lit_mask=torch.as_tensor(fa.lit_mask.astype(dtype)),
        clause_mask=torch.as_tensor(fa.clause_mask.astype(dtype)),
        var_occ=torch.as_tensor(fa.var_occ, dtype=torch.int64),
        occ_mask=torch.as_tensor(fa.occ_mask.astype(dtype)),
        zeta=zeta, rigidity=rigidity, dv_strategy=dv_strategy, bucket_slices=buckets,
    )
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_match(j, t, dtype):
    for name, a, b in zip(("dv", "dxs", "dxl"), t[:3], j[:3]):
        assert a.dtype == b.dtype == dtype, name
        np.testing.assert_allclose(a, b, err_msg=name, **TOL[dtype])
    np.testing.assert_array_equal(t[3], j[3], err_msg="allsat")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("dv_strategy", ["gather", "segment_sum"])
def test_twin_matches_jax_rhs(dtype, seed, rigidity, dv_strategy):
    """Unit clauses included (min_width=1): their own literal's gradient
    is +-inf in both packages."""
    fa, v, xs, xl = _setup(seed, dtype)
    j, t = _both(fa, v, xs, xl, 0.01, rigidity, dv_strategy)
    _assert_match(j, t, dtype)


@pytest.mark.parametrize("dv_strategy", ["gather", "segment_sum"])
def test_twin_matches_jax_rhs_batched_and_bucketed(dv_strategy):
    fa, v, xs, xl = _setup(4, np.float64, min_width=1, max_width=5, bucket=True, B=5)
    assert len(fa.bucket_slices) > 1
    j, t = _both(fa, v, xs, xl, 0.1, "paper", dv_strategy, buckets=fa.bucket_slices)
    _assert_match(j, t, np.float64)
    assert t[0].shape == (5, fa.n_vars_padded) and t[3].shape == (5,)


@pytest.mark.parametrize("rigidity", ["paper", "reference"])
def test_exact_zero_values_and_ties(rigidity):
    """v at exactly +-1 gives clause values of exactly 0 (the reference
    gate's only firing point) and duplicated minima (second_min == min)."""
    formula = CNFFormula(
        [(Literal(0), Literal(1), Literal(2)), (Literal(0, True), Literal(1), Literal(3))], 4
    )
    fa = compile_formula(formula, dtype=np.float64, clause_pad=8, var_pad=8)
    v = np.zeros(fa.n_vars_padded)
    v[:4] = [1.0, 1.0, -0.2, 0.5]
    xs = np.full(fa.n_clauses_padded, 0.5)
    xl = np.full(fa.n_clauses_padded, 2.0)
    j, t = _both(fa, v, xs, xl, 0.1, rigidity, "gather")
    _assert_match(j, t, np.float64)


def test_contradictory_units_nan_and_clamp():
    """(x0) and (not x0): +inf and -inf gradients meet in x0's sum as NaN
    in both packages, and the NaN-ignoring clamp of the step then holds
    v[0] at the lower bound (Rust's f64::max semantics)."""
    import jax

    from odesat_tpu.models.ode import formula_device, init_state, make_step_fn
    from odesat_tpu.utils.config import ODEConfig as JODE
    from odesat_tpu_torch.models import ode as tode
    from odesat_tpu_torch.utils.config import ODEConfig

    formula = CNFFormula([(Literal(0),), (Literal(0, True),), (Literal(1), Literal(2))], 3)
    fa = compile_formula(formula, dtype=np.float64, clause_pad=8, var_pad=8)
    v = np.zeros(fa.n_vars_padded)
    v[:3] = [0.3, -0.4, 0.9]
    xs = np.full(fa.n_clauses_padded, 0.5)
    xl = np.full(fa.n_clauses_padded, 3.0)
    j, t = _both(fa, v, xs, xl, 0.01, "paper", "gather")
    assert np.isnan(t[0][0]) and np.isnan(j[0][0])
    _assert_match(j, t, np.float64)

    kw = dict(step_size=0.05, dtype="float64")
    jstate = init_state(fa, 2, jax.random.PRNGKey(0), JODE(**kw), v0=v)
    jout = make_step_fn(fa, 0.01, JODE(**kw))(jstate, formula_device(fa, dtype=np.float64))
    ode = ODEConfig(**kw)
    tstate = tode.init_state(fa, 2, None, ode, "cpu", v0=v)
    tout = tode.make_step_fn(fa, 0.01, ode)(tstate, tode.formula_device(fa, "cpu", torch.float64))
    assert tout.v[0, 0].item() == -1.0 == float(jout.v[0, 0])
    np.testing.assert_allclose(tout.v.numpy(), np.asarray(jout.v), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tout.xs.numpy(), np.asarray(jout.xs), rtol=1e-12, atol=1e-12)
