"""The chunk kernel's plain torch version (odesat_tpu_torch/ops/
fused_chunk.py) against the JAX package's Pallas chunk kernel
(``odesat_tpu.ops.fused_pallas.make_fused_chunk``) run in interpret mode
on the CPU, from the same NumPy state; the fixtures follow
tests/test_fused.py.

Tolerances: float32 to rtol 2e-4 / atol 2e-5 (tests/test_fused.py's), the
done latches exactly. bfloat16 rounding to rtol 1e-2 / atol 1e-2 over
8-step chunks: the two versions sum dv in different orders, so they
differ in the last f32 bit; that can flip one bf16 rounding of v (a step
of 2^-8 relative), and past about ten adaptive steps the dt control
amplifies such a flip to ~4e-3 in the state and ~7% in dt.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
holds it against the plain version there, and chip_smoke.py does the same
at the real shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables  # noqa: E402
from odesat_tpu.ops.fused_pallas import make_fused_chunk as jax_fused_chunk  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.generate import random_ksat  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy, state_from_numpy  # noqa: E402
from odesat_tpu_torch.models.ode import make_chunk_runner  # noqa: E402
from odesat_tpu_torch.ops import _cuda  # noqa: E402
from odesat_tpu_torch.ops import fused_chunk as fc  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from tests.conftest import random_formula  # noqa: E402
from tests.torch_parity import assert_states_close, jax_state, numpy_state  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _fixture(seed=0, n_vars=30, n_clauses=80):
    formula = random_ksat(n_vars, n_clauses, k=3, seed=seed)
    _, normalized = normalize_cnf_variables(formula)
    return compile_formula(normalized)


def _run_both(fa, kw, arrays, steps, zeta=0.05):
    jout = jax_fused_chunk(fa, zeta, JODE(**kw), steps, interpret=True)(jax_state(arrays))
    fn = fc.make_fused_chunk(formula_arrays_from_numpy(fa), zeta, ODEConfig(**kw), steps, "cpu")
    tout = fn(state_from_numpy(*arrays, device="cpu"))
    return tout, jout


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_f32(mode, rigidity, seed):
    fa = _fixture(seed)
    kw = dict(step_size=0.02 if mode == "fixed" else None, tolerance=1e-3, rigidity=rigidity)
    tout, jout = _run_both(fa, kw, numpy_state(fa, 8, seed), 16)
    assert_states_close(tout, jout, dt_rtol=2e-4, **F32)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
def test_plain_matches_pallas_bf16(mode, rigidity):
    fa = _fixture(0)
    kw = dict(step_size=0.02 if mode == "fixed" else None, rigidity=rigidity,
              matmul_dtype="bfloat16")
    tout, jout = _run_both(fa, kw, numpy_state(fa, 8, 0), 8)
    assert_states_close(tout, jout, dt_rtol=1e-2, **BF16)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("bucket", [False, True])
def test_plain_matches_pallas_mixed_widths(mode, bucket):
    """Clauses of width 2 to 5 leave padding slots inside the (K, Mp)
    grid, and width buckets reorder the clause axis; neither may change a
    clause's value."""
    formula = random_formula(np.random.default_rng(8), 40, 120, max_width=5, min_width=2)
    fa = compile_formula(normalize_cnf_variables(formula)[1], bucket=bucket, min_bucket=16)
    assert fa.max_width == 5 and (len(fa.bucket_slices) > 1) == bucket
    kw = dict(step_size=0.02 if mode == "fixed" else None)
    tout, jout = _run_both(fa, kw, numpy_state(fa, 8, 8), 16)
    assert_states_close(tout, jout, dt_rtol=2e-4, **F32)


@pytest.mark.parametrize("B", [1, 5, 100])
def test_plain_odd_batch_sizes(B):
    fa = _fixture(6)
    tout, jout = _run_both(fa, dict(step_size=0.02), numpy_state(fa, B, 6), 5)
    assert tout.v.shape == (B, fa.n_vars_padded)
    assert_states_close(tout, jout, **F32)


@pytest.mark.parametrize("rigidity", ["paper", "reference"])
def test_plain_exact_zero_clause_values(rigidity):
    """v pinned at exactly +-1 makes satisfied literals' values exactly 0,
    where the reference gate (val == c) fires and the A1/A2 forms meet."""
    fa = _fixture(5)
    arrays = list(numpy_state(fa, 8, 5))
    v = arrays[0]
    v[:, 0::2] = np.where(v[:, 0::2] >= 0, 1.0, -1.0)
    tout, jout = _run_both(fa, dict(step_size=0.02, rigidity=rigidity), arrays, 8)
    assert_states_close(tout, jout, **F32)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_plain_freezes_solved_trajectories(mode):
    """A planted instance solved inside one chunk: the done rows of the
    next chunk's output equal its input (fixed mode takes dt=0 updates,
    which the clamps leave unchanged; adaptive mode never advances)."""
    formula = random_ksat(20, 40, k=3, seed=2, planted=True)
    _, normalized = normalize_cnf_variables(formula)
    fa = formula_arrays_from_numpy(compile_formula(normalized))
    ode = ODEConfig(step_size=0.05 if mode == "fixed" else None)
    fn = fc.make_fused_chunk(fa, 0.01, ode, 200, "cpu")
    out1 = fn(state_from_numpy(*numpy_state(fa, 16, 2), device="cpu"))
    assert out1.done.any()
    out2 = fn(out1)
    d = out1.done
    for a, b in zip(out2[:4], out1[:4]):
        assert torch.equal(a[d], b[d])


def test_rejections():
    fa = formula_arrays_from_numpy(_fixture())
    with pytest.raises(ValueError, match="float64"):
        fc.make_fused_chunk(fa, 0.01, ODEConfig(step_size=0.01, dtype="float64"), 4, "cpu")
    with pytest.raises(ValueError, match="shared"):
        fc.make_fused_chunk(fa, 0.01, ODEConfig(dt_mode="shared"), 4, "cpu")
    with pytest.raises(ValueError, match="shared"):
        make_chunk_runner(fa, 0.01, ODEConfig(dt_mode="shared", dv_strategy="fused"), 4, "cpu")
    units = compile_formula(
        normalize_cnf_variables(random_formula(np.random.default_rng(0), 8, 20, 3, 1))[1]
    )
    assert units.min_width == 1
    with pytest.raises(ValueError, match="unit clauses"):
        fc.make_fused_chunk(formula_arrays_from_numpy(units), 0.01, ODEConfig(step_size=0.01),
                            4, "cpu")
    # a formula past the shared-memory gate (about 10k clauses)
    big = compile_formula(normalize_cnf_variables(random_ksat(2400, 10200, seed=0))[1])
    big = formula_arrays_from_numpy(big)
    assert fc.fused_smem_bytes(big, fixed=True) > fc.SMEM_LIMIT_BYTES
    assert not fc.fused_supported(big, fixed=True)
    with pytest.raises(ValueError, match="shared memory"):
        fc.make_fused_chunk(big, 0.01, ODEConfig(step_size=0.01), 4, "cpu")


def test_cpu_path_never_touches_the_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load the CUDA library")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    before = fc.launches
    fa = formula_arrays_from_numpy(_fixture())
    fn = fc.make_fused_chunk(fa, 0.05, ODEConfig(step_size=0.02), 4, "cpu")
    out = fn(state_from_numpy(*numpy_state(fa, 4, 0), device="cpu"))
    assert torch.isfinite(out.v).all()
    assert fc.launches == before


def test_chunk_tables_describe_the_formula():
    """The CSR lists hold every real (k, m) slot once, grouped by its
    variable, and the plain version's padded table is the same lists."""
    jfa = compile_formula(
        normalize_cnf_variables(random_formula(np.random.default_rng(3), 15, 40, 4, 2))[1],
        bucket=True, min_bucket=4,
    )
    fa = formula_arrays_from_numpy(jfa)
    t = fc.chunk_tables(fa)
    plain = fc.plain_tables(fc.chunk_spec(fa, 0.05, ODEConfig(step_size=0.02), "cpu"))
    np.testing.assert_array_equal(plain.lit_var.numpy(), np.where(fa.lit_mask > 0, fa.lit_var, 0))
    np.testing.assert_array_equal(plain.negated.numpy(), (fa.lit_mask > 0) & (fa.sign < 0))
    K, Mp = fa.lit_var.shape
    on = fa.lit_mask > 0
    assert (t.lit_code >= 0).sum() == on.sum() == t.occ_slot.size
    for i in range(fa.n_vars_padded):
        slots = t.occ_slot[t.occ_ptr[i]:t.occ_ptr[i + 1]]
        ks, ms = np.divmod(slots, Mp)
        assert np.all(fa.lit_var[ks, ms] == i) and np.all(on[ks, ms])
        assert plain.occ_pad[i, : slots.size].tolist() == list(slots)
        assert bool((plain.occ_pad[i, slots.size:] == K * Mp).all())
        codes = t.lit_code[slots]
        np.testing.assert_array_equal(codes >> 1, i)
        np.testing.assert_array_equal(codes & 1, fa.sign[ks, ms] < 0)

