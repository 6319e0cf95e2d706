"""The clause-sharded compile and kernel B5 (odesat_tpu_torch/ops/
shard_stream.py) on the CPU, where the wrappers run B5's plain version.

Held against the JAX package (``odesat_tpu.ops.shard_stream``) from the
same NumPy state, on the mixed-width formula of tests/test_shard_stream.py:

* ``compile_stream_sharded``: array-equal, field by field, for S in
  {1, 2, 4}, bucketed or not, window-sorted or not;
* ``rhs`` mode per shard against ``make_stream_shard_rhs`` in interpret
  mode: dxs/dxl rtol 1e-5 / atol 1e-6, dv summed over shards rtol 1e-4 /
  atol 1e-5, allsat equal (the JAX test's own tolerances, its :111-118);
* ``fixed`` and ``second`` at S=1: one step of ``make_fused_clause_step``
  against the JAX one (``clause_axis=None``, interpret mode), rtol 2e-4 /
  atol 2e-5 (the two sum dv in other orders).

The CUDA kernel runs only on the card: tests/test_torch_cuda.py holds it
against these plain versions there, and chip_smoke.py at the real shapes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from odesat_tpu.cnf import normalize_cnf_variables  # noqa: E402
from odesat_tpu.cnf.formula import CNFFormula, Literal  # noqa: E402
from odesat_tpu.models import ode as jode  # noqa: E402
from odesat_tpu.ops import shard_stream as jss  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy, state_from_numpy  # noqa: E402
from odesat_tpu_torch.models.loop import copy_state  # noqa: E402
from odesat_tpu_torch.models.ode import ODEState  # noqa: E402
from odesat_tpu_torch.ops import shard_stream as tss  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from tests.torch_parity import port_formula  # noqa: E402

ZETA = 0.001
SMALL = (60, 260, 60)  # two width buckets


def _mixed_width_formula(n_vars=160, seed=7, counts=(150, 500, 120)):
    """tests/test_shard_stream.py's: widths 2, 3 and 4 -> several buckets
    (``counts`` clauses of each; the interpret-mode comparisons take a
    smaller formula with two buckets)."""
    rng = np.random.default_rng(seed)
    clauses = []
    for width, count in zip((2, 3, 4), counts):
        for _ in range(count):
            vs = rng.choice(n_vars, size=width, replace=False)
            clauses.append(tuple(Literal(int(v) + 1, bool(rng.integers(0, 2))) for v in vs))
    return normalize_cnf_variables(CNFFormula(clauses, n_vars))[1]


def _inputs(fa, B, seed):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, (B, fa.n_vars_padded)).astype(np.float32)
    xs = (np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)) + 0.1).astype(np.float32)
    xl = (rng.uniform(1.0, 3.0, (B, fa.n_clauses_padded))).astype(np.float32)
    return v, xs, xl


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("window_sort", [True, False])
def test_compile_matches_jax(n_shards, bucket, window_sort):
    normalized = _mixed_width_formula()
    kw = dict(bucket=bucket, window_sort=window_sort)
    jfa, _ = jss.compile_stream_sharded(normalized, n_shards, **kw)
    tfa, plan = tss.compile_stream_sharded(port_formula(normalized), n_shards, **kw)
    for name in ("lit_var", "sign", "lit_mask", "clause_mask", "xs_init", "var_occ",
                 "occ_mask"):
        x, y = getattr(tfa, name), getattr(jfa, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in ("bucket_slices", "n_slots", "n_vars_padded", "n_clauses_padded", "max_occ",
                 "min_width", "max_width", "n_clauses"):
        assert getattr(tfa, name) == getattr(jfa, name), name
    assert tfa.shard_plan is plan and plan.n_shards == n_shards
    assert plan.mp_local * n_shards == tfa.n_clauses_padded
    # every real clause sits in exactly one column
    seen = np.sort(plan.clause_of[plan.clause_of >= 0])
    np.testing.assert_array_equal(seen, np.arange(normalized.num_clauses))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_plan_travels_through_interop(n_shards):
    """A JAX compile_stream_sharded formula carries its plan into the port:
    the same per-shard tables as the port's own compile."""
    normalized = _mixed_width_formula(seed=3)
    jfa, _ = jss.compile_stream_sharded(normalized, n_shards)
    carried = formula_arrays_from_numpy(jfa).shard_plan
    _, own = tss.compile_stream_sharded(port_formula(normalized), n_shards)
    assert carried.n_shards == own.n_shards and carried.mp_local == own.mp_local
    for a, b in zip(carried.tables, own.tables):
        for name in ("lit_code", "occ_ptr", "occ_slot"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def test_shard_tables_restrict_the_global_csr():
    """Each shard's CSR is the whole formula's, restricted to its clauses,
    in the same order; the occurrence codes are 2*m_local + negated."""
    from odesat_tpu_torch.ops.fused_chunk import chunk_tables

    fa, plan = tss.compile_stream_sharded(port_formula(_mixed_width_formula(seed=5)), 2)
    whole = chunk_tables(fa)
    Mp, ml = fa.n_clauses_padded, plan.mp_local
    g_var = np.repeat(np.arange(fa.n_vars_padded), np.diff(whole.occ_ptr))
    g_m = whole.occ_slot % Mp
    for s, t in enumerate(plan.tables):
        keep = (g_m >= s * ml) & (g_m < (s + 1) * ml)
        l_var = np.repeat(np.arange(fa.n_vars_padded), np.diff(t.occ_ptr))
        np.testing.assert_array_equal(l_var, g_var[keep])
        np.testing.assert_array_equal(t.occ_slot % ml, g_m[keep] - s * ml)
        codes = plan.occ_code(s)
        np.testing.assert_array_equal(codes >> 1, g_m[keep] - s * ml)


@pytest.mark.parametrize("n_shards,rigidity",
                         [(1, "paper"), (2, "paper"), (4, "paper"), (1, "reference"),
                          (2, "reference"), (4, "reference")])
def test_rhs_plain_matches_pallas_per_shard(n_shards, rigidity):
    normalized = _mixed_width_formula(seed=11, counts=SMALL)
    jfa, jplan = jss.compile_stream_sharded(normalized, n_shards)
    tfa = formula_arrays_from_numpy(jfa)
    B = 4
    v, xs, xl = _inputs(jfa, B, seed=n_shards)
    jrhs = jss.make_stream_shard_rhs(jplan, ZETA, JODE(step_size=0.01, rigidity=rigidity),
                                     interpret=True)
    ode = ODEConfig(step_size=0.01, rigidity=rigidity)
    ml = jplan.mp_local
    dv_j = np.zeros((B, jfa.n_vars_padded), np.float64)
    dv_t = np.zeros_like(dv_j)
    for s in range(n_shards):
        seg = slice(s * ml, (s + 1) * ml)
        jdv, jdxs, jdxl, jsat = jrhs(
            jnp.asarray(v), jnp.asarray(xs[:, seg]), jnp.asarray(xl[:, seg]),
            jnp.asarray(jplan.planes[s]), jnp.asarray(jplan.lo[s]), jnp.asarray(jplan.bias[s]),
            jnp.asarray(jfa.clause_mask[seg]))
        trhs = tss.make_stream_shard_rhs(tfa, ZETA, ode, "cpu", shard=s)
        tdv, tdxs, tdxl, tsat = trhs(*(torch.as_tensor(np.ascontiguousarray(a))
                                       for a in (v, xs[:, seg], xl[:, seg])))
        np.testing.assert_allclose(tdxs.numpy(), np.asarray(jdxs), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tdxl.numpy(), np.asarray(jdxl), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tsat.numpy(), np.asarray(jsat))
        dv_j += np.asarray(jdv, np.float64)
        dv_t += tdv.numpy().astype(np.float64)
    np.testing.assert_allclose(dv_t, dv_j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
def test_clause_step_matches_pallas_at_s1(mode, rigidity):
    """One step of the fused clause step at S=1: ``fixed`` is B5's fixed
    mode, ``adaptive`` its rhs and second modes around the torch dt
    control; against the JAX step with ``clause_axis=None``."""
    normalized = _mixed_width_formula(seed=17, counts=SMALL)
    jfa, _ = jss.compile_stream_sharded(normalized, 1)
    tfa = formula_arrays_from_numpy(jfa)
    kw = dict(step_size=0.01 if mode == "fixed" else None, rigidity=rigidity)
    B = 6
    v, xs, xl = _inputs(jfa, B, seed=23)
    dt = np.full(B, 0.05, np.float32)
    done = np.zeros(B, bool)
    done[1] = True
    jstep = jss.make_fused_clause_step(jfa, ZETA, JODE(**kw), interpret=True)
    jout = jstep(jode.ODEState(*(jnp.asarray(a) for a in (v, xs, xl, dt, done))),
                 jode.formula_device(jfa))
    tstep = tss.make_fused_clause_step(tfa, ZETA, ODEConfig(**kw), device="cpu")
    tout = tstep(state_from_numpy(v, xs, xl, dt, done, device="cpu"))
    for name in ("v", "xs", "xl", "dt"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
    # the frozen row kept its state in the adaptive integrator
    if mode == "adaptive":
        np.testing.assert_array_equal(tout.v[1].numpy(), v[1])


def test_single_device_runner_matches_step_loop():
    fa, _ = tss.compile_stream_sharded(port_formula(_mixed_width_formula(seed=2)), 1)
    ode = ODEConfig(step_size=0.02)
    v, xs, xl = _inputs(fa, 3, seed=1)
    state = state_from_numpy(v, xs, xl, np.full(3, 0.01, np.float32), np.zeros(3, bool), "cpu")
    run = tss.make_single_device_runner(fa, ZETA, ode, 4, device="cpu")
    ref = copy_state(state)  # the runner consumes its input
    out = run(state)
    step = tss.make_fused_clause_step(fa, ZETA, ode, device="cpu")
    for _ in range(4):
        ref = step(ref)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # the result lies in the caller's storage, as JAX's donated state
    for a, b in zip(out, state):
        assert a.data_ptr() == b.data_ptr()
    with pytest.raises(ValueError, match="n_shards=1"):
        tss.make_single_device_runner(
            tss.compile_stream_sharded(port_formula(_mixed_width_formula()), 2)[0], ZETA, ode, 4,
            device="cpu")


def test_gate_and_rejections():
    normalized = port_formula(_mixed_width_formula(seed=4))
    fa, plan = tss.compile_stream_sharded(normalized, 2)
    assert tss.stream_shard_supported(fa, plan)
    assert not tss.stream_shard_supported(fa, plan, "float64")
    unit = CNFFormula([(Literal(0, False),), (Literal(0, True), Literal(1, False))], 2)
    ufa, uplan = tss.compile_stream_sharded(port_formula(unit), 2)
    assert not tss.stream_shard_supported(ufa, uplan)
    with pytest.raises(ValueError, match="unit-clause"):
        tss.make_fused_clause_step(ufa, ZETA, ODEConfig(step_size=0.01), device="cpu")
    shared = ODEConfig(tolerance=1e-3, dt_mode="shared")
    with pytest.raises(ValueError, match="per-trajectory dt"):
        tss.make_fused_clause_step(fa, ZETA, shared, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        tss.make_fused_clause_step(fa, ZETA, ODEConfig(step_size=0.01, dtype="float64"),
                                   device="cpu")
    # a tensor on neither CUDA nor the CPU has no path
    rhs = tss.make_stream_shard_rhs(fa, ZETA, ODEConfig(step_size=0.01), "cpu")
    meta = torch.empty((2, fa.n_vars_padded), device="meta")
    with pytest.raises(ValueError, match="no shard RHS path"):
        rhs(meta, meta, meta)
    # the CUDA entry refuses a spec on the CPU instead of falling back
    with pytest.raises(ValueError, match="CUDA tensors"):
        tss.shard_stream_cuda("rhs", rhs.spec, *(torch.zeros(1),) * 3)


def test_fused_clause_step_keeps_state_dataclass():
    fa, _ = tss.compile_stream_sharded(port_formula(_mixed_width_formula(seed=6)), 1)
    step = tss.make_fused_clause_step(fa, ZETA, ODEConfig(step_size=0.01), device="cpu")
    v, xs, xl = _inputs(fa, 2, seed=0)
    out = step(state_from_numpy(v, xs, xl, np.full(2, 0.01, np.float32), np.zeros(2, bool), "cpu"))
    assert isinstance(out, ODEState)
    assert dataclasses.is_dataclass(step.spec)
