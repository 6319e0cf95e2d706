"""The scan tier's chunk (``odesat_tpu_torch/ops/scan_chunk.py``) on the CPU:
its multi-chunk runner against the JAX package's, and the step's
capture-safety contract.

On a CUDA state the scan chunk is a CUDA graph of ``chunk_steps`` steps that
the device loop runs (tests/test_torch_cuda.py holds it to the step loop
on the card); on a CPU state it is the plain loop of steps, and the
multi-chunk runner is the host loop. Here:

* the port's ``make_multi_chunk_runner`` on the scan strategies (``gather``,
  ``segment_sum``, and ``pallas`` through B10's plain version against JAX's
  Pallas RHS in interpret mode, which runs float32 only, and in float64
  against JAX's ``gather``), fixed, adaptive and ``dt_mode="shared"``, in
  float32 and float64, stopping on any and on all, from the same NumPy
  state as JAX's (odesat_tpu/models/ode.py:443): ``steps_advanced`` exactly,
  the state within tests/test_torch_ode.py's tolerances (float64 rtol 1e-9 /
  atol 1e-12, float32 rtol 2e-4 / atol 2e-5), done exactly; a state
  stopped at entry advances 0 steps and comes back unchanged;
* one step of every strategy and integrator makes no tensor from a Python
  number and reads nothing back to the host (``new_tensor``,
  ``torch.tensor``, ``as_tensor``, ``.item()``, ``.tolist()``, ``.cpu()``,
  ``bool()`` of a tensor), recorded by a ``TorchFunctionMode``: what a CUDA
  graph capture needs;
* ``make_step_fn``'s outputs equal, bit for bit, a reference step that makes
  its constants from Python floats as the step did before it built them
  ahead;
* ``segment_sum``'s sorted sum (its CUDA path: no float atomics) adds every
  segment in index order, as ``index_add_`` does on the CPU, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.overrides import TorchFunctionMode  # noqa: E402

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.models import ode as jode  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.generate import random_ksat  # noqa: E402
from odesat_tpu_torch.constants import DT_MAX, DT_MIN, EPSILON, XL_CAP_PER_CLAUSE  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy, state_from_numpy  # noqa: E402
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.ops import _cuda  # noqa: E402
from odesat_tpu_torch.ops import rhs as rhs_ops  # noqa: E402
from odesat_tpu_torch.ops import rhs_kernel as rk  # noqa: E402
from odesat_tpu_torch.ops import scan_chunk  # noqa: E402
from odesat_tpu_torch.ops.device_loop import KernelChunk  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    assert_states_close,
    jax_state,
    numpy_state,
    to_numpy,
)

TOL = {"float64": dict(rtol=1e-9, atol=1e-12), "float32": dict(rtol=2e-4, atol=2e-5)}
STRATEGIES = ("gather", "segment_sum", "pallas")
MODES = ("fixed", "adaptive", "shared")
INNER, MAX_CHUNKS, B = 4, 6, 8


def _fa(dtype=np.float32):
    """A planted 3-SAT instance at ratio 3 (every clause of width 3, as B10
    takes): rows solve within a few chunks at dt 0.2."""
    formula = random_ksat(16, 48, k=3, seed=4, planted=True)
    return jcompile(jnormalize(formula)[1], dtype=dtype, clause_pad=8, var_pad=8)


def _kw(strategy, mode, dtype):
    return dict(step_size=0.2 if mode == "fixed" else None, tolerance=1e-3, dtype=dtype,
                dt_mode="shared" if mode == "shared" else "per-trajectory",
                dv_strategy=strategy)


def _run_both(strategy, mode, dtype, stop_on, done_rows=()):
    np_dtype = np.float64 if dtype == "float64" else np.float32
    fa = _fa(np_dtype)
    arrays = numpy_state(fa, B, seed=2, dtype=np_dtype, dt0=0.2)
    arrays[4][list(done_rows)] = True
    kw = _kw(strategy, mode, dtype)
    # JAX's Pallas RHS does not run float64 in interpret mode: there its
    # gather RHS, the semantics B10's plain version meets, is the reference
    jkw = dict(kw, dv_strategy="gather") if strategy == "pallas" and dtype == "float64" else kw
    jrun = jode.make_multi_chunk_runner(fa, 0.05, JODE(**jkw), INNER, MAX_CHUNKS, stop_on=stop_on)
    jst, jsteps = jrun(jax_state(arrays), jode.formula_device(fa, dtype=np_dtype))
    tfa = formula_arrays_from_numpy(fa)
    trun = tode.make_multi_chunk_runner(tfa, 0.05, ODEConfig(**kw), INNER, MAX_CHUNKS, "cpu",
                                        stop_on=stop_on)
    tst, tsteps = trun(state_from_numpy(*arrays, device="cpu"),
                       tode.formula_device(tfa, "cpu", tode.state_dtype(ODEConfig(**kw))))
    return arrays, (jst, int(jsteps)), (tst, tsteps)


@pytest.mark.parametrize("dtype,stop_on", [("float32", "any"), ("float64", "all")])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_multi_chunk_runner_matches_jax(strategy, mode, dtype, stop_on):
    """One dispatch of up to 6 chunks of 4 steps from the same state: the
    same steps_advanced as JAX's while loop, the state within tolerance."""
    _, (jst, jsteps), (tst, tsteps) = _run_both(strategy, mode, dtype, stop_on)
    assert tsteps == jsteps
    assert_states_close(tst, jst, dt_rtol=TOL[dtype]["rtol"], **TOL[dtype])


def test_a_stop_falls_inside_the_dispatch():
    """The planted instance's first solved row lands inside the dispatch,
    so the runner stops after chunk k with 1 < k < 6, with JAX."""
    _, (jst, jsteps), (tst, tsteps) = _run_both("gather", "fixed", "float32", "any")
    assert INNER < tsteps == jsteps < INNER * MAX_CHUNKS
    assert to_numpy(tst)[4].any()


@pytest.mark.parametrize("stop_on", ["any", "all"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_state_stopped_at_entry_runs_no_chunk(strategy, stop_on):
    """Row 0 done ("any") or every row done ("all") at entry: both
    packages advance 0 steps and hand the state back unchanged."""
    rows = [0] if stop_on == "any" else range(B)
    arrays, (jst, jsteps), (tst, tsteps) = _run_both(strategy, "adaptive", "float32", stop_on,
                                                     rows)
    assert jsteps == tsteps == 0
    for got in (to_numpy(jst), to_numpy(tst)):
        for name, a, b in zip(("v", "xs", "xl", "dt", "done"), got, arrays):
            np.testing.assert_array_equal(a, b, err_msg=name)


# ------------------------------------------------ the capture-safety contract


class _Recorder(TorchFunctionMode):
    """Records the calls that make a tensor from host values or read one
    back to the host."""

    WATCHED = {
        torch.Tensor.new_tensor: "new_tensor", torch.tensor: "torch.tensor",
        torch.as_tensor: "as_tensor", torch.Tensor.item: ".item()",
        torch.Tensor.tolist: ".tolist()", torch.Tensor.cpu: ".cpu()",
        torch.Tensor.__bool__: "bool()",
    }

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.WATCHED:
            self.calls.append(self.WATCHED[func])
        return func(*args, **(kwargs or {}))


def _port_case(strategy, mode, dtype="float32"):
    np_dtype = np.float64 if dtype == "float64" else np.float32
    fa = formula_arrays_from_numpy(_fa(np_dtype))
    arrays = numpy_state(fa, B, seed=5, dtype=np_dtype, dt0=0.2)
    ode = ODEConfig(**_kw(strategy, mode, dtype))
    dev = tode.formula_device(fa, "cpu", tode.state_dtype(ode))
    return fa, ode, state_from_numpy(*arrays, device="cpu"), dev


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_step_is_capture_safe(strategy, mode):
    """A step built for the state's device makes no tensor from a Python
    number and reads nothing back to the host, on its first call too."""
    fa, ode, state, dev = _port_case(strategy, mode)
    step = tode.make_step_fn(fa, 0.05, ode, device="cpu")
    with _Recorder() as rec:
        out = step(state, dev)
    assert rec.calls == []
    assert torch.isfinite(out.v).all()
    with _Recorder() as rec:  # the recorder sees what the old step made
        _reference_step(fa, 0.05, ode)(state, dev)
    assert "new_tensor" in rec.calls


def _reference_step(fa, zeta, ode):
    """The step as it was before it built its constants ahead: each made
    from a Python float at every step (``new_tensor``), the same RHS."""
    xl_cap = XL_CAP_PER_CLAUSE * fa.n_clauses
    buckets = fa.bucket_slices if len(fa.bucket_slices) > 1 else None
    kernel = (rk.make_rhs_kernel(fa, zeta, ode.rigidity, ode.dtype)
              if ode.dv_strategy == "pallas" else None)

    def derivs(v, xs, xl, dev):
        if kernel is not None:
            return kernel(v, xs, xl, dev)
        return rhs_ops.compute_derivatives(
            v, xs, xl, lit_var=dev.lit_var, sign=dev.sign, lit_mask=dev.lit_mask,
            clause_mask=dev.clause_mask, var_occ=dev.var_occ, occ_mask=dev.occ_mask,
            zeta=zeta, rigidity=ode.rigidity, dv_strategy=ode.dv_strategy,
            bucket_slices=buckets)

    def update(v, xs, xl, dv, dxs, dxl, dt):
        dt_c = dt.unsqueeze(-1)

        def clamp(x, lo, hi):
            return torch.fmin(torch.fmax(x, x.new_tensor(lo)), x.new_tensor(hi))

        return (clamp(v + dt_c * dv, -1.0, 1.0), clamp(xs + dt_c * dxs, EPSILON, 1.0 - EPSILON),
                clamp(xl + dt_c * dxl, 1.0, xl_cap))

    def freeze(cond, new, old):
        return torch.where(cond.unsqueeze(-1), new, old)

    def step(state, dev):
        dv, dxs, dxl, allsat = derivs(state.v, state.xs, state.xl, dev)
        if ode.step_size is not None:
            dt_b = torch.where(state.done, 0.0, state.v.new_tensor(float(ode.step_size)))
            v, xs, xl = update(state.v, state.xs, state.xl, dv, dxs, dxl, dt_b)
            return tode.ODEState(v, xs, xl, state.dt, state.done | allsat)
        advance = ~state.done & ~allsat
        dt = state.dt
        fv, fxs, fxl = update(state.v, state.xs, state.xl, dv, dxs, dxl, dt)
        hv, hxs, hxl = update(state.v, state.xs, state.xl, dv, dxs, dxl, 0.5 * dt)
        dv2, dxs2, dxl2, _ = derivs(hv, hxs, hxl, dev)
        tv, txs, txl = update(hv, hxs, hxl, dv2, dxs2, dxl2, 0.5 * dt)
        err = torch.maximum(
            (fv - tv).abs().amax(dim=-1),
            torch.maximum((fxs - txs).abs().amax(dim=-1), (fxl - txl).abs().amax(dim=-1)))
        if ode.dt_mode == "shared":
            err = torch.where(advance, err, 0.0).amax().reshape(1).expand(advance.shape)
        ratio = err.new_tensor(float(ode.tolerance)) / err.clamp_min(1e-30)
        new_dt = torch.clamp(dt * torch.sqrt(ratio), DT_MIN, DT_MAX)
        return tode.ODEState(freeze(advance, tv, state.v), freeze(advance, txs, state.xs),
                             freeze(advance, txl, state.xl),
                             torch.where(advance, new_dt, state.dt), state.done | allsat)

    return step


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_step_equals_the_float_constant_reference_bit_for_bit(strategy, mode, dtype):
    """Eight steps of make_step_fn and of the reference from one state:
    every field bit-identical."""
    fa, ode, state, dev = _port_case(strategy, mode, dtype)
    step = tode.make_step_fn(fa, 0.05, ode, device="cpu")
    ref = _reference_step(fa, 0.05, ode)
    a = b = state
    for _ in range(8):
        a, b = step(a, dev), ref(b, dev)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


# ------------------------------------------------------ the runner on the CPU


def test_scan_chunk_on_the_cpu_is_the_step_loop(monkeypatch):
    """make_chunk_runner's scan strategies return the scan chunk, a
    KernelChunk the device loop takes; on a CPU state it runs the steps one
    by one, builds no CUDA library and counts no launch."""

    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load a CUDA library")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    fa, ode, state, dev = _port_case("pallas", "adaptive")
    chunk = tode.make_chunk_runner(fa, 0.05, ode, 5, "cpu")
    assert isinstance(chunk, scan_chunk.ScanChunk) and isinstance(chunk, KernelChunk)
    assert chunk.chunk_steps == 5
    before = (scan_chunk.launches, rk.launches)
    step = tode.make_step_fn(fa, 0.05, ode, device="cpu")
    want = state
    for _ in range(5):
        want = step(want, dev)
    got = chunk(state, dev)
    for name, x, y in zip(got._fields, got, want):
        assert torch.equal(x, y), name
    assert (scan_chunk.launches, rk.launches) == before
    assert chunk.graphs == {}


# ------------------------------------------------ segment_sum on the card


def test_segment_sum_sorted_adds_in_index_order():
    """Segments of 0 to 70 entries: the sorted sum (segment_sum's CUDA path,
    run here on the CPU) lists every entry once, adds each segment's
    entries in index order as the CPU's index_add_ does (the same bits), and
    an empty segment sums to 0; leading axes pass through."""
    rng = np.random.default_rng(3)
    n = 40
    counts = rng.integers(0, 71, n)
    counts[[0, 7]] = 0
    ids = rng.permutation(np.repeat(np.arange(n), counts))
    order, offsets = rhs_ops.segment_table(ids, n, "cpu")
    np.testing.assert_array_equal(np.sort(order.numpy()), np.arange(ids.size))
    np.testing.assert_array_equal(np.diff(offsets.numpy()), counts)
    x = torch.as_tensor(rng.standard_normal((2, 3, ids.size)))
    got = rhs_ops.segment_sum_sorted(x, (order, offsets))
    want = x.new_zeros(2, 3, n).index_add_(-1, torch.as_tensor(ids), x)
    assert got.shape == (2, 3, n) and torch.equal(got, want)
    assert (got[..., [0, 7]] == 0).all()


def test_determinism_soak_needs_a_card():
    """The soak runs the CUDA kernels only: without a card it raises."""
    from odesat_tpu_torch.tools.determinism_soak import soak

    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        soak(1, device="cpu")
