"""The tile layout of the single-step RHS kernel B10 (ops/rhs_kernel.py)
on the CPU, where its wrapper runs the plain version.

B10 runs a tile of R trajectories a CTA (csrc/stream_chunk.cu, namespace
``rhs``), resident or streamed, R and the form chosen per formula and
dtype from the shared-memory footprint. What the CPU can check is held
here:

- R, the form, the window and the footprint each formula gets, in float32
  and float64, against the layout written out word for word;
- the gate at R = 1 is no narrower than the one-CTA-a-trajectory gate it
  replaces (v beside 32 words of reduction scratch), on the formulas
  chip_smoke.py gives B10 and at the boundary Np;
- the tables the kernel reads (slot positions, clause segments);
- the plain version, which runs the kernel's arithmetic in its order,
  against the JAX package's Pallas kernel in interpret mode at ragged B and
  on a width-bucketed formula, float32 rtol/atol 1e-5
  (tests/test_torch_rhs.py's), and against the twin's gather RHS, float32
  rtol 2e-4 / atol 2e-5 and float64 1e-12 (the two sum in other orders);
- the wrapper: CPU tensors run the plain version, a CPU spec never
  launches, past the gate it raises.

The kernel runs only on the card: tests/test_torch_cuda.py holds it against
the plain version there, bit for bit.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.ops.rhs_pallas import make_pallas_rhs  # noqa: E402
from odesat_tpu_torch.cnf import CNFFormula, compile_formula, normalize_cnf_variables  # noqa: E402
from odesat_tpu_torch.cnf.formula import Literal  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy  # noqa: E402
from odesat_tpu_torch.models.ode import formula_device  # noqa: E402
from odesat_tpu_torch.ops import fused_chunk as fc  # noqa: E402
from odesat_tpu_torch.ops import rhs_kernel as rk  # noqa: E402
from tests.conftest import random_formula  # noqa: E402
from tests.test_torch_lanes import FORMULAS  # noqa: E402

LIMIT = 232448
SM_SHARED = 233472  # an H100 SM's shared memory; each CTA keeps 1 KB of it
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (lanes, resident, window, threads) in float32 and float64; the window is
# Mp when resident
PLANS = {
    "hard.cnf": ((8, True, 256, 256), (4, True, 256, 256)),
    "uf250": ((1, True, 1152, 256), (1, True, 1152, 512)),
    "n1k preprocessed": ((1, True, 6528, 512), (8, False, 1362, 512)),
    "local n=4096": ((8, False, 1572, 512), (4, False, 1570, 512)),
    "widths 2,3,5 bucketed": ((1, True, 1536, 256), (1, True, 1536, 512)),
}
_FA: dict = {}


def _fa(name):
    if name not in _FA:
        _FA[name] = FORMULAS[name]()
    return _FA[name]


def _row(n, itemsize, lanes):
    """A row's bytes in the tile, written out: whole 16-byte units and,
    for R > 1, the next size that is 16 bytes past a multiple of 128."""
    nbytes = (n * itemsize + 15) // 16 * 16
    while lanes > 1 and nbytes % 128 != 16:
        nbytes += 16
    return nbytes


def _bytes(Np, window, nnz, itemsize, lanes, resident):
    """The kernel's carve-up, written out: 32 bytes of barriers and flags,
    then per trajectory a row of v, of the window's xs and of its xl;
    resident, two such buffers and a row of contributions."""
    state = _row(Np, itemsize, lanes) + 2 * _row(window, itemsize, lanes)
    return 32 + lanes * (2 * state + _row(nnz, itemsize, lanes) if resident else state)


def _old_gate(Np, itemsize):
    """The one-CTA-a-trajectory gate: v beside 32 words of reduction
    scratch."""
    return itemsize * (32 + Np) <= LIMIT


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("itemsize", [4, 8])
def test_lanes_form_and_footprint_per_formula(name, itemsize):
    fa = _fa(name)
    Np, Mp, nnz = fa.n_vars_padded, fa.n_clauses_padded, rk.nnz_of(fa)
    want = PLANS[name][itemsize == 8]
    plan = rk.rhs_plan(Np, Mp, nnz, itemsize)
    assert (plan.lanes, plan.resident, plan.window, plan.threads) == want
    assert plan.smem_bytes == _bytes(Np, plan.window, nnz, itemsize, plan.lanes,
                                     plan.resident) <= LIMIT
    assert plan.smem_bytes == rk.rhs_smem_bytes(Np, plan.window, nnz, itemsize, plan.lanes,
                                                plan.resident)
    if plan.resident:  # the most lanes with which 4 CTAs share an SM, else 2, else 1
        for share in (4, 2, 1):
            room = min(LIMIT, SM_SHARED // share - 1024)
            fit = [R for R in (8, 4, 2, 1) if _bytes(Np, Mp, nnz, itemsize, R, True) <= room]
            if fit:
                assert (plan.lanes, plan.threads) == (fit[0], 256 if share == 4 else 512)
                break
    else:  # the resident form does not fit, and the window is the most the stream holds
        assert _bytes(Np, Mp, nnz, itemsize, 1, True) > LIMIT
        assert _bytes(Np, plan.window + 16 // itemsize, nnz, itemsize, plan.lanes, False) > LIMIT
        if plan.lanes < 8:
            assert rk.widest_window(Np, itemsize, 2 * plan.lanes) < rk.MIN_WINDOW


@pytest.mark.parametrize("name", ["hard.cnf", "uf250", "n1k preprocessed"])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_gate_is_no_narrower_on_the_smoke_formulas(name, itemsize):
    """The formulas chip_smoke.py gives B10 pass the old gate and the new
    one, and every R up to the plan's fits in the plan's form, as does the
    streamed form in small windows (rhs_lane_range gives every R that
    fits)."""
    fa = _fa(name)
    Np, Mp, nnz = fa.n_vars_padded, fa.n_clauses_padded, rk.nnz_of(fa)
    assert _old_gate(Np, itemsize)
    assert rk.rhs_supported(fa, "float64" if itemsize == 8 else "float32")
    best = rk.rhs_plan(Np, Mp, nnz, itemsize)
    R = best.lanes
    while R >= 1:
        plan = rk.rhs_plan(Np, Mp, nnz, itemsize, lanes=R, resident=best.resident)
        assert plan is not None and plan.smem_bytes <= LIMIT and plan.lanes == R
        streamed = rk.rhs_plan(Np, Mp, nnz, itemsize, lanes=R, resident=False, window=7)
        assert streamed.window == 7 and not streamed.resident
        R //= 2
    most = rk.rhs_lane_range(Np, Mp, nnz, itemsize, best.resident)
    assert most[0] >= best.lanes and most == [most[0] >> s for s in range(most[0].bit_length())]
    assert most[0] == 8 or rk.rhs_plan(Np, Mp, nnz, itemsize, 2 * most[0], best.resident) is None


@pytest.mark.parametrize("Np,itemsize,fits", [
    (58080, 4, True), (58096, 4, True), (58097, 4, False), (58112, 4, False),
    (29024, 8, True), (29048, 8, True), (29049, 8, False), (29056, 8, False),
])
@pytest.mark.parametrize("Mp", [128, 43776])
def test_gate_at_the_boundary(Np, itemsize, fits, Mp):
    """At R = 1 the streamed form needs v and a window of one clause: the
    gate takes every Np the old one took (58,080 in float32, 29,024 in
    float64) and a few more, and no formula past it."""
    plan = rk.rhs_plan(Np, Mp, 3 * Mp, itemsize)
    assert (plan is not None) == fits
    if _old_gate(Np, itemsize):
        assert fits
    if fits:
        assert plan.lanes == 1 and not plan.resident and plan.smem_bytes <= LIMIT
        assert plan.smem_bytes == _bytes(Np, plan.window, 3 * Mp, itemsize, 1, False)
    fa = SimpleNamespace(min_width=3, n_vars_padded=Np, n_clauses_padded=Mp,
                         lit_mask=np.ones((3, Mp), np.int8))
    dtype = "float64" if itemsize == 8 else "float32"
    assert rk.rhs_supported(fa, dtype) == fits
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            rk.make_rhs_kernel(fa, 0.05, "paper", dtype)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_forced_plans_fit_or_refuse(lanes):
    """A forced R and form: resident where it fits, else None; streamed
    with its window capped at Mp and at what fits, in 16-byte units."""
    fa = _fa("uf250")
    Np, Mp, nnz = fa.n_vars_padded, fa.n_clauses_padded, rk.nnz_of(fa)
    res = rk.rhs_plan(Np, Mp, nnz, 4, lanes=lanes, resident=True)
    assert (res is not None) == (_bytes(Np, Mp, nnz, 4, lanes, True) <= LIMIT)
    assert (res is not None) == (lanes <= 4)
    streamed = rk.rhs_plan(Np, Mp, nnz, 4, lanes=lanes, resident=False)
    room = rk.widest_window(Np, 4, lanes)
    assert _bytes(Np, room, 0, 4, lanes, False) <= LIMIT < _bytes(Np, room + 4, 0, 4, lanes, False)
    assert streamed.window == min(Mp, room - room % 4) and streamed.smem_bytes <= LIMIT
    too_wide = rk.rhs_plan(Np, Mp, nnz, 4, lanes=lanes, resident=False, window=room + 4)
    assert (too_wide is None) == (room < Mp)


def test_launch_plan_halves_streamed_lanes_for_the_last_wave(monkeypatch):
    """A streamed launch (a CTA a tile) halves R where the last wave of
    tiles would idle the card: the n=4096 instance at B=1024, 128 tiles of
    8 on 132 SMs, stays at 8; at B=100, 13 tiles of 8, it takes 2 (50
    tiles). A resident launch walks its tiles with as many CTAs as the card
    holds and keeps its R."""
    monkeypatch.setattr(rk, "launch_lanes", lambda lanes, B, device: fc.wave_lanes(lanes, B, 132))
    spec = rk.rhs_spec(_fa("local n=4096"), 0.05, "paper", "cpu")
    assert rk.launch_plan(spec, 1024, torch.float32).lanes == 8
    small = rk.launch_plan(spec, 100, torch.float32)
    assert small == rk.rhs_plan(spec.Np, spec.Mp, spec.nnz, 4, 2, False) and small.lanes == 2
    hard = rk.rhs_spec(_fa("hard.cnf"), 0.05, "paper", "cpu")
    assert rk.launch_plan(hard, 100, torch.float32) == rk.rhs_plan(hard.Np, hard.Mp, hard.nnz, 4)
    assert rk.rhs_plan(hard.Np, hard.Mp, hard.nnz, 4, 8, True, 64) is None  # a resident window is Mp
    wide = rk.rhs_spec(_fa("hard.cnf"), 0.05, "paper", "cpu")
    with pytest.raises(ValueError, match="shared memory"):
        rk.launch_plan(SimpleNamespace(**{**vars(wide), "Np": 58112, "nnz": 0}), 4, torch.float32)


@pytest.mark.parametrize("bucket", [False, True])
def test_spec_tables(bucket):
    """The slot positions invert the CSR lists (padding -1), and the
    segments cover the clause axis by width."""
    fa = _fa("widths 2,3,5 bucketed") if bucket else _fa("hard.cnf")
    spec = rk.rhs_spec(fa, 0.05, "reference", "cpu")
    pos, slot = spec.slot_pos.numpy(), spec.occ_slot.numpy()
    np.testing.assert_array_equal(pos[slot], np.arange(slot.size))
    assert (pos >= 0).sum() == slot.size == spec.nnz
    assert (pos[spec.lit_code.numpy() < 0] == -1).all()
    seg = spec.segments.numpy()
    assert seg[0, 0] == 0 and seg[-1, 1] == spec.Mp and (seg[1:, 0] == seg[:-1, 1]).all()
    assert not spec.paper and not spec.bf16
    assert len(seg) == (3 if bucket else 1)


def _inputs(fa, B, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, fa.n_vars_padded)).astype(dtype),
            rng.uniform(0.001, 0.999, (B, fa.n_clauses_padded)).astype(dtype),
            rng.uniform(1.0, 50.0, (B, fa.n_clauses_padded)).astype(dtype))


def _jax_formula(bucket, seed=5):
    rng = np.random.default_rng(seed)
    formula = random_formula(rng, 40, 150, max_width=5, min_width=2)
    return jcompile(jnormalize(formula)[1], bucket=bucket, min_bucket=16)


@pytest.mark.parametrize("B", [1, 7, 33])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("bucket", [False, True])
def test_plain_matches_pallas_rhs_at_ragged_batches(B, rigidity, bucket):
    """The kernel-order plain version against the TPU kernel in interpret
    mode, float32, rtol/atol 1e-5; allsat exactly."""
    jfa = _jax_formula(bucket)
    v, xs, xl = _inputs(jfa, B, seed=B)
    j = make_pallas_rhs(jfa, 0.05, rigidity=rigidity, interpret=True)(
        jnp.asarray(v), jnp.asarray(xs), jnp.asarray(xl))
    fa = formula_arrays_from_numpy(jfa)
    t = rk.rhs_plain(torch.as_tensor(v), torch.as_tensor(xs), torch.as_tensor(xl),
                     rk.rhs_spec(fa, 0.05, rigidity, "cpu"))
    for name, a, b in zip(("dv", "dxs", "dxl"), t[:3], j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("bucket", [False, True])
def test_plain_matches_the_twin(dtype, rigidity, bucket):
    """The kernel-order plain version against the twin's gather RHS:
    float32 rtol 2e-4 / atol 2e-5, float64 1e-12; allsat exactly."""
    fa = formula_arrays_from_numpy(_jax_formula(bucket, seed=6))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    v, xs, xl = (torch.as_tensor(a) for a in _inputs(fa, 33, 1, np_dtype))
    spec = rk.rhs_spec(fa, 0.05, rigidity, "cpu")
    out = rk.rhs_plain(v, xs, xl, spec)
    buckets = fa.bucket_slices if len(fa.bucket_slices) > 1 else None
    ref = rk.rhs_twin(v, xs, xl, formula_device(fa, "cpu", dtype), 0.05, rigidity, buckets)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == torch.float32 else dict(rtol=1e-12, atol=1e-12)
    for a, b in zip(out[:3], ref[:3]):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, **tol)
    assert torch.equal(out[3], ref[3])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_path_runs_the_plain_version(dtype):
    """make_rhs_kernel on CPU tensors is the plain version over a spec it
    builds on the CPU, bit for bit, and launches nothing."""
    fa = _fa("widths 2,3,5 bucketed")
    np_dtype = np.float64 if dtype == "float64" else np.float32
    v, xs, xl = (torch.as_tensor(a) for a in _inputs(fa, 7, 2, np_dtype))
    before = rk.launches
    out = rk.make_rhs_kernel(fa, 0.05, "paper", dtype)(v, xs, xl)
    ref = rk.rhs_plain(v, xs, xl, rk.rhs_spec(fa, 0.05, "paper", "cpu"))
    assert rk.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_satisfied_rows_are_allsat():
    """A row that satisfies every clause (each clause has a literal at
    value 0, so c = 0) comes out allsat, with dxs and dxl from c = 0; a
    random row does not."""
    rng = np.random.default_rng(3)
    truth = rng.integers(0, 2, 40).astype(bool)
    clauses = []
    for w in (2, 3, 3, 5):
        for _ in range(30):
            vs = rng.choice(40, size=w, replace=False)
            neg = rng.integers(0, 2, w).astype(bool)
            neg[0] = not truth[vs[0]]  # the first literal is true under `truth`
            clauses.append(tuple(Literal(int(x), bool(n)) for x, n in zip(vs, neg)))
    names, formula = normalize_cnf_variables(CNFFormula(clauses, 40))
    fa = compile_formula(formula, bucket=True, min_bucket=16)
    spec = rk.rhs_spec(fa, 0.05, "paper", "cpu")
    v = np.zeros((2, spec.Np), np.float32)
    for old, new in names.items():
        v[0, new] = 1.0 if truth[old] else -1.0
    v[1] = rng.uniform(-1, 1, spec.Np)
    xs, xl = np.full((2, spec.Mp), 0.5, np.float32), np.ones((2, spec.Mp), np.float32)
    out = rk.rhs_plain(*(torch.as_tensor(a) for a in (v, xs, xl)), spec)
    assert out[3].tolist() == [True, False]
    on = spec.clause_on
    torch.testing.assert_close(out[1][0][on], torch.full_like(out[1][0][on], 20.0 * 0.501 * -0.25))
    torch.testing.assert_close(out[2][0][on], torch.full_like(out[2][0][on], 5.0 * -0.05))


def test_a_cpu_spec_never_launches():
    fa = _fa("hard.cnf")
    spec = rk.rhs_spec(fa, 0.05, "paper", "cpu")
    v, xs, xl = (torch.as_tensor(a) for a in _inputs(fa, 2, 0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.rhs_cuda(v, xs, xl, spec)
    with pytest.raises(ValueError, match="no RHS kernel path"):
        rk.make_rhs_kernel(fa, 0.05)(v.to("meta"), xs.to("meta"), xl.to("meta"))


def test_rhs_kernel_imports_no_jax():
    code = (
        "import sys\n"
        "import odesat_tpu_torch.ops.rhs_kernel\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'odesat_tpu' not in sys.modules, 'the JAX package imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
