"""The large-formula chunk kernel B2 (odesat_tpu_torch/ops/stream_chunk.py)
and the single-step RHS kernel B10 (ops/rhs_kernel.py) on the CPU, where
each wrapper runs its plain version: B2's is B1's ``fused_chunk_plain``,
B10's B1's RHS pass over B10's tables (``rhs_plain``).

They are held against the JAX package's Pallas kernels run in interpret
mode (``odesat_tpu.ops.stream_pallas.make_stream_chunk`` and
``odesat_tpu.ops.rhs_pallas.make_pallas_rhs``) from the same NumPy state,
on the fixtures of tests/test_stream.py: a width-bucketed mixed-width
formula, a window-sorted locally-structured one, odd batch sizes, the
freeze of solved rows, and the rejections.

Tolerances: float32 rtol 2e-4 / atol 2e-5 with dt to rtol 2e-4
(tests/test_stream.py's), the done latches exactly; bfloat16 rtol 1e-2 /
atol 1e-2 over 8-step chunks, for the reason tests/test_torch_fused.py
gives (the two sum dv in different orders, which can flip one bf16
rounding of v). The RHS in float32 to rtol 1e-5 / atol 1e-5
(tests/test_torch_rhs.py's).

The CUDA kernels run only on the card: tests/test_torch_cuda.py holds them
against these plain versions there, and chip_smoke.py at the real shapes.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from odesat_tpu.cnf import compile_formula, normalize_cnf_variables  # noqa: E402
from odesat_tpu.cnf.formula import CNFFormula, Literal  # noqa: E402
from odesat_tpu.models import ode as jode  # noqa: E402
from odesat_tpu.ops.rhs_pallas import make_pallas_rhs  # noqa: E402
from odesat_tpu.ops.stream_pallas import make_stream_chunk as jax_stream_chunk  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.generate import random_ksat, random_local_ksat  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy, state_from_numpy  # noqa: E402
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.ops import _cuda  # noqa: E402
from odesat_tpu_torch.ops import fused_chunk as fc  # noqa: E402
from odesat_tpu_torch.ops import rhs_kernel as rk  # noqa: E402
from odesat_tpu_torch.ops import stream_chunk as sc  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from tests.conftest import random_formula  # noqa: E402
from tests.torch_parity import assert_states_close, jax_state, numpy_state  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mixed_fixture(seed=0, n_vars=40, per_width=40, widths=(2, 3, 3, 3, 4, 5)):
    """tests/test_stream.py's: mixed widths in several width buckets."""
    rng = random.Random(seed)
    clauses = []
    for w in widths:
        for _ in range(per_width):
            vs = rng.sample(range(n_vars), w)
            clauses.append(tuple(Literal(v, rng.random() < 0.5) for v in vs))
    _, normalized = normalize_cnf_variables(CNFFormula(clauses, n_vars))
    return compile_formula(normalized, bucket=True, min_bucket=16)


def _run_both(fa, kw, arrays, steps, zeta=0.05):
    jout = jax_stream_chunk(fa, zeta, JODE(**kw), steps, interpret=True)(jax_state(arrays))
    fn = sc.make_stream_chunk(formula_arrays_from_numpy(fa), zeta, ODEConfig(**kw), steps, "cpu")
    tout = fn(state_from_numpy(*arrays, device="cpu"))
    return tout, jout


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
def test_plain_matches_pallas_stream_bucketed(mode, rigidity):
    fa = _mixed_fixture()
    assert len(fa.bucket_slices) > 1 and fa.min_width == 2
    kw = dict(step_size=0.02 if mode == "fixed" else None, tolerance=1e-3, rigidity=rigidity)
    tout, jout = _run_both(fa, kw, numpy_state(fa, 8, 0), 12)
    assert_states_close(tout, jout, dt_rtol=2e-4, **F32)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
def test_plain_matches_pallas_stream_bf16(mode, rigidity):
    fa = _mixed_fixture(seed=1)
    kw = dict(step_size=0.02 if mode == "fixed" else None, rigidity=rigidity,
              matmul_dtype="bfloat16")
    tout, jout = _run_both(fa, kw, numpy_state(fa, 8, 1), 8)
    assert_states_close(tout, jout, dt_rtol=1e-2, **BF16)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_plain_matches_pallas_stream_window_sorted_local(mode):
    """A window-sorted, locally-structured formula (the layout the JAX
    kernel's per-span variable windows are built for)."""
    formula = random_local_ksat(512, 1536, k=3, locality=64, seed=2)
    fa = compile_formula(normalize_cnf_variables(formula)[1], window_sort=True)
    kw = dict(step_size=0.02 if mode == "fixed" else None)
    tout, jout = _run_both(fa, kw, numpy_state(fa, 8, 2), 10)
    assert_states_close(tout, jout, dt_rtol=2e-4, **F32)


@pytest.mark.parametrize("B", [1, 5, 100])
def test_plain_matches_pallas_stream_odd_batch_sizes(B):
    fa = _mixed_fixture(seed=6, widths=(2, 3, 4))
    tout, jout = _run_both(fa, dict(step_size=0.02), numpy_state(fa, B, 6), 5)
    assert tout.v.shape == (B, fa.n_vars_padded)
    assert_states_close(tout, jout, **F32)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_plain_freezes_solved_rows_like_pallas_stream(mode):
    """A planted instance solved inside one chunk; in the next chunk the
    rows done before it come out unchanged, and both packages agree."""
    fa = compile_formula(normalize_cnf_variables(random_ksat(20, 40, k=3, seed=2,
                                                             planted=True))[1])
    kw = dict(step_size=0.05 if mode == "fixed" else None)
    fn = sc.make_stream_chunk(formula_arrays_from_numpy(fa), 0.01, ODEConfig(**kw), 4, "cpu")
    out1 = state_from_numpy(*numpy_state(fa, 16, 2), device="cpu")
    for _ in range(100):  # until some rows are done and some still run
        out1 = fn(out1)
        if out1.done.any():
            break
    assert out1.done.any() and not out1.done.all()
    arrays = tuple(t.numpy() for t in out1)
    tout, jout = _run_both(fa, kw, arrays, 20, zeta=0.01)
    d = out1.done
    for a, b in zip(tout[:4], out1[:4]):
        assert torch.equal(a[d], b[d])
    assert_states_close(tout, jout, dt_rtol=2e-4, **F32)


def test_rejections():
    fa = formula_arrays_from_numpy(_mixed_fixture())
    with pytest.raises(ValueError, match="float64"):
        sc.make_stream_chunk(fa, 0.01, ODEConfig(step_size=0.01, dtype="float64"), 4, "cpu")
    with pytest.raises(ValueError, match="shared"):
        sc.make_stream_chunk(fa, 0.01, ODEConfig(dt_mode="shared"), 4, "cpu")
    with pytest.raises(ValueError, match="shared"):
        tode.make_chunk_runner(fa, 0.01, ODEConfig(dt_mode="shared", dv_strategy="stream"), 4,
                               "cpu")
    units = formula_arrays_from_numpy(compile_formula(
        normalize_cnf_variables(random_formula(np.random.default_rng(0), 8, 20, 3, 1))[1]))
    assert units.min_width == 1 and not sc.stream_supported(units, fixed=True)
    with pytest.raises(ValueError, match="unit-clause"):
        sc.make_stream_chunk(units, 0.01, ODEConfig(step_size=0.01), 4, "cpu")
    with pytest.raises(ValueError, match="unit-clause"):
        rk.make_rhs_kernel(units, 0.01)
    with pytest.raises(ValueError, match="unit"):
        make_pallas_rhs(compile_formula(
            normalize_cnf_variables(random_formula(np.random.default_rng(0), 8, 20, 3, 1))[1]),
            0.01, interpret=True)


def test_stream_lanes_take_the_v_window():
    """B2 keeps only its v window (and hv) in shared memory, R trajectories
    of it: 8 (fixed) and 4 (adaptive) a CTA at the n=4096 shapes, the lane
    words beside them, and one trajectory where v and hv alone nearly fill
    the CTA."""
    assert sc.stream_lanes(4096, True) == 8 and sc.stream_lanes(4096, False) == 4
    assert sc.stream_smem_bytes(4096, True, 8) == 4 * (3 + 24 + 8 * 4096)
    half = (sc.SMEM_LIMIT_BYTES // 4 - 32) // 2  # v and hv of one trajectory
    assert sc.stream_lanes(half, False) == 1 and sc.stream_lanes(128, False) == 32


def test_gate_takes_formulas_past_b1():
    """Uniform random 3-SAT n=2000, m=8000 (Mp=8064) is past B1's
    shared-memory gate in both integrators and inside B2's."""
    fa = formula_arrays_from_numpy(compile_formula(
        normalize_cnf_variables(random_ksat(2000, 8000, k=3, seed=11, planted=True))[1]))
    for fixed in (True, False):
        assert not fc.fused_supported(fa, fixed)
        assert sc.stream_supported(fa, fixed)


def test_auto_ladder_takes_stream_past_b1s_gate_on_cuda(caplog):
    """The ladder on a CUDA device: fused inside B1's gate, stream past it,
    the twin for unit clauses, float64 and a batch-shared adaptive dt; on
    the CPU always the twin. simulate_batch logs the choice."""
    big = formula_arrays_from_numpy(compile_formula(
        normalize_cnf_variables(random_ksat(2000, 8000, k=3, seed=11))[1]))
    small = formula_arrays_from_numpy(_mixed_fixture())
    for ode in (ODEConfig(step_size=0.01), ODEConfig()):
        assert tode.resolve_strategy(small, ode, "cuda") == "fused"
        assert tode.resolve_strategy(big, ode, "cuda") == "stream"
        assert tode.resolve_strategy(big, ode, "cpu") == "gather"
    assert tode.resolve_strategy(big, ODEConfig(dtype="float64"), "cuda") == "gather"
    assert tode.resolve_strategy(big, ODEConfig(dt_mode="shared"), "cuda") == "gather"
    assert tode.resolve_strategy(big, ODEConfig(dt_mode="shared", step_size=0.01),
                                 "cuda") == "stream"
    assert tode.resolve_strategy(big, ODEConfig(dv_strategy="stream"), "cpu") == "stream"


def test_chunk_runner_dispatches_stream():
    """make_chunk_runner('stream') is B2's wrapper; on CPU tensors it runs
    the plain version and agrees with JAX's make_chunk_runner('stream')."""
    fa = _mixed_fixture(seed=4, widths=(2, 3, 4))
    arrays = numpy_state(fa, 8, 4)
    run = tode.make_chunk_runner(formula_arrays_from_numpy(fa), 0.05,
                                 ODEConfig(step_size=0.02, dv_strategy="stream"), 10, "cpu")
    assert run.spec.lanes == 32
    tout = run(state_from_numpy(*arrays, device="cpu"))
    jrun = jode.make_chunk_runner(fa, 0.05, JODE(step_size=0.02, dv_strategy="stream"), 10,
                                  donate=False)
    jout = jrun(jax_state(arrays), jode.formula_device(fa))
    assert_states_close(tout, jout, **F32)


def test_cpu_path_never_touches_the_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load the CUDA library")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    before = (sc.launches, rk.launches)
    fa = formula_arrays_from_numpy(_mixed_fixture())
    fn = sc.make_stream_chunk(fa, 0.05, ODEConfig(step_size=0.02), 4, "cpu")
    out = fn(state_from_numpy(*numpy_state(fa, 4, 0), device="cpu"))
    assert torch.isfinite(out.v).all()
    step = tode.make_step_fn(fa, 0.05, ODEConfig(step_size=0.02, dv_strategy="pallas"))
    out = step(state_from_numpy(*numpy_state(fa, 4, 0), device="cpu"),
               tode.formula_device(fa, "cpu"))
    assert torch.isfinite(out.v).all()
    assert (sc.launches, rk.launches) == before


def test_new_modules_do_not_import_jax():
    code = (
        "import sys\n"
        "import odesat_tpu_torch, odesat_tpu_torch.cli\n"
        "import odesat_tpu_torch.ops.stream_chunk, odesat_tpu_torch.ops.rhs_kernel\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'odesat_tpu' not in sys.modules, 'the JAX package imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_occurrence_codes_describe_the_formula():
    """Each occurrence code names the clause column and sign of the slot
    the CSR list holds, so the variable phase reads the right clause."""
    fa = formula_arrays_from_numpy(_mixed_fixture(seed=2))
    t = fc.chunk_tables(fa)
    codes = sc.occurrence_codes(t)
    ks, ms = np.divmod(t.occ_slot, t.Mp)
    np.testing.assert_array_equal(codes >> 1, ms)
    np.testing.assert_array_equal(codes & 1, fa.sign[ks, ms] < 0)


# ------------------------------------------------ B10, the single-step RHS


@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("bucket", [False, True])
def test_rhs_plain_matches_pallas_rhs(rigidity, bucket):
    """B10's plain version against the TPU kernel in interpret mode, f32."""
    rng = np.random.default_rng(5)
    formula = random_formula(rng, 40, 150, max_width=5, min_width=2)
    fa = compile_formula(normalize_cnf_variables(formula)[1], bucket=bucket, min_bucket=16)
    B = 8
    v = rng.uniform(-1, 1, (B, fa.n_vars_padded)).astype(np.float32)
    xs = rng.uniform(0.001, 0.999, (B, fa.n_clauses_padded)).astype(np.float32)
    xl = rng.uniform(1.0, 50.0, (B, fa.n_clauses_padded)).astype(np.float32)
    j = make_pallas_rhs(fa, 0.05, rigidity=rigidity, interpret=True)(
        jnp.asarray(v), jnp.asarray(xs), jnp.asarray(xl))
    tfa = formula_arrays_from_numpy(fa)
    fn = rk.make_rhs_kernel(tfa, 0.05, rigidity)
    t = fn(torch.as_tensor(v), torch.as_tensor(xs), torch.as_tensor(xl),
           tode.formula_device(tfa, "cpu"))
    for name, a, b in zip(("dv", "dxs", "dxl"), t[:3], j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_pallas_step_matches_jax_pallas_step(mode):
    """dv_strategy='pallas' integrated over 10 steps by both packages' step
    functions (the port's on the CPU runs B10's plain version)."""
    fa = _mixed_fixture(seed=7, widths=(2, 3, 4))
    kw = dict(step_size=0.02 if mode == "fixed" else None, dv_strategy="pallas")
    arrays = numpy_state(fa, 8, 7)
    jstep = jode.make_step_fn(fa, 0.05, JODE(**kw))
    jstate, jdev = jax_state(arrays), jode.formula_device(fa)
    tfa = formula_arrays_from_numpy(fa)
    tstep = tode.make_step_fn(tfa, 0.05, ODEConfig(**kw))
    tstate, tdev = state_from_numpy(*arrays, device="cpu"), tode.formula_device(tfa, "cpu")
    for _ in range(10):
        jstate, tstate = jstep(jstate, jdev), tstep(tstate, tdev)
    assert_states_close(tstate, jstate, dt_rtol=2e-4, **F32)


def test_rhs_gate():
    """B10 takes the mixed fixture in both dtypes; at the n=4096 shapes the
    float64 tile streams its clause state; one trajectory's float64 v past
    a CTA is refused."""
    fa = formula_arrays_from_numpy(_mixed_fixture())
    assert rk.rhs_supported(fa) and rk.rhs_supported(fa, "float64")
    plan = rk.rhs_plan(4096, 17280, 51609, 8)
    assert not plan.resident and plan.lanes == 4 and plan.smem_bytes <= sc.SMEM_LIMIT_BYTES
    assert rk.rhs_plan(sc.SMEM_LIMIT_BYTES // 8, 128, 384, 8) is None
