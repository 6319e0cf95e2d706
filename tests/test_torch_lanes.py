"""The lane-tile layout of the single-device chunk kernels B1
(ops/fused_chunk.py) and B2 (ops/stream_chunk.py) on the CPU.

Both kernels run a tile of R trajectories a CTA (csrc/ode_lanes.cuh), R
chosen per formula from its shared-memory footprint. What the CPU can check
is held here:

- the gates are no narrower than the one-CTA-a-trajectory gates they
  replace (those footprints are written out below), on the formulas the
  port drives at their compiled shapes;
- the R each formula gets and its footprint against 232,448 bytes;
- the tables the kernels read (clause segments, slot positions);
- a ragged batch: the last tile's padded lanes are done rows, every row is
  computed on its own, so the plain version over the padded batch equals it
  over the batch, row for row and exactly;
- the plain version against the JAX package's Pallas kernels in interpret
  mode at ragged batches, to the tolerances of tests/test_torch_fused.py
  (float32 rtol 2e-4 / atol 2e-5).

The kernels themselves run on the card: tests/test_torch_cuda.py holds them
against the plain version there, exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.ops.fused_pallas import make_fused_chunk as jax_fused_chunk  # noqa: E402
from odesat_tpu.ops.stream_pallas import make_stream_chunk as jax_stream_chunk  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.generate import random_ksat as jrandom_ksat  # noqa: E402
from odesat_tpu_torch.cnf import (  # noqa: E402
    CNFFormula,
    compile_formula,
    normalize_cnf_variables,
    parse_dimacs_file,
)
from odesat_tpu_torch.interop import formula_arrays_from_numpy, state_from_numpy  # noqa: E402
from odesat_tpu_torch.models.ode import ODEState, compile_for_config  # noqa: E402
from odesat_tpu_torch.ops import fused_chunk as fc  # noqa: E402
from odesat_tpu_torch.ops import stream_chunk as sc  # noqa: E402
from odesat_tpu_torch.ops.tiles import n_tiles, tile, untile  # noqa: E402
from odesat_tpu_torch.preprocess import preprocess_formula  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
from odesat_tpu_torch.utils.generate import (  # noqa: E402
    random_ksat,
    random_local_ksat,
    uf_instance,
)
from tests.torch_parity import assert_states_close, jax_state, numpy_state  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-5)
LIMIT = 232448


def _norm(formula):
    return normalize_cnf_variables(formula)[1]


def _mixed():
    return _norm(CNFFormula(
        [c for k in (2, 3, 5) for c in random_ksat(300, 400, k=k, seed=10 + k).clauses], 300))


def _hard():
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "hard.cnf")
    return _norm(parse_dimacs_file(path))


def _for_config(formula):
    return compile_for_config(_norm(formula), SolverConfig())


# the formulas the port drives, laid out as chip_smoke.py and the CLI lay
# them out: phase 3's (window-sorted, one bucketed), then the real-size ones
FORMULAS = {
    "ksat n=50 m=213": lambda: compile_formula(_norm(random_ksat(50, 213, seed=0)),
                                               window_sort=True),
    "ksat n=100 m=300 k=4": lambda: compile_formula(_norm(random_ksat(100, 300, k=4, seed=1)),
                                                    window_sort=True),
    "ksat n=200 m=852 planted": lambda: compile_formula(
        _norm(random_ksat(200, 852, seed=2, planted=True)), window_sort=True),
    "widths 2,3,5": lambda: compile_formula(_mixed(), window_sort=True),
    "widths 2,3,5 bucketed": lambda: compile_formula(_mixed(), window_sort=True, bucket=True),
    "hard.cnf": lambda: compile_formula(_hard(), window_sort=True),
    "uf250": lambda: compile_formula(_norm(uf_instance(250, seed=0)), window_sort=True),
    "n1k preprocessed": lambda: _for_config(
        preprocess_formula(random_ksat(1000, 4300, k=3, seed=7, planted=True), 7.0)[0]),
    "planted n=2000 m=7000 preprocessed": lambda: _for_config(
        preprocess_formula(random_ksat(2000, 7000, k=3, seed=11, planted=True), 7.0)[0]),
    "planted n=2000 m=8000": lambda: _for_config(random_ksat(2000, 8000, k=3, seed=11,
                                                             planted=True)),
    "local n=4096": lambda: _for_config(random_local_ksat(4096, 17203, k=3, locality=256,
                                                          seed=3)),
}

# (B1 fixed, B1 adaptive, B2 fixed, B2 adaptive) trajectories a CTA; None: past the gate
LANES = {
    "ksat n=50 m=213": (32, 16, 32, 32),
    "ksat n=100 m=300 k=4": (16, 8, 32, 32),
    "ksat n=200 m=852 planted": (8, 4, 32, 32),
    "widths 2,3,5": (4, 2, 32, 32),
    "widths 2,3,5 bucketed": (4, 2, 32, 32),
    "hard.cnf": (32, 16, 32, 32),
    "uf250": (8, 4, 32, 32),
    "n1k preprocessed": (None, None, 32, 32),
    "planted n=2000 m=7000 preprocessed": (None, None, 32, 16),
    "planted n=2000 m=8000": (None, None, 16, 8),
    "local n=4096": (None, None, 8, 4),
}


def _old_fused_bytes(fa, fixed):
    """B1's footprint before the lane tiles: one trajectory a CTA, 32 words
    of reduction scratch, adaptive trial states hv, hxs, hxl, fv, fxs, fxl."""
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, int((fa.lit_mask > 0).sum())
    words = K * Mp + (Np + 1) + nnz + Np + 2 * Mp + K * Mp + 32
    return 4 * (words + (0 if fixed else 2 * (Np + 2 * Mp)))


def _old_stream_bytes(fa, fixed):
    """B2's resident part before the lane tiles: 32 words of reduction
    scratch, v and (adaptive) hv; everything else could spill."""
    return 4 * (32 + fa.n_vars_padded * (1 if fixed else 2))


@pytest.fixture(scope="module")
def formulas():
    return {name: make() for name, make in FORMULAS.items()}


@pytest.mark.parametrize("name", list(FORMULAS))
def test_gates_are_no_narrower(formulas, name):
    """Every formula the one-trajectory gates took, the lane-tile gates
    take, in both integrators."""
    fa = formulas[name]
    for fixed in (True, False):
        if fa.min_width >= 2 and _old_fused_bytes(fa, fixed) <= LIMIT:
            assert fc.fused_supported(fa, fixed)
        if fa.min_width >= 2 and _old_stream_bytes(fa, fixed) <= LIMIT:
            assert sc.stream_supported(fa, fixed)


@pytest.mark.parametrize("name", list(FORMULAS))
def test_lanes_and_footprint(formulas, name):
    """The trajectories a CTA each formula gets, the largest power of two
    up to 32 whose footprint fits 232,448 bytes."""
    fa = formulas[name]
    got = (fc.fused_lanes(fa, True), fc.fused_lanes(fa, False),
           sc.stream_lanes(fa.n_vars_padded, True), sc.stream_lanes(fa.n_vars_padded, False))
    assert got == LANES[name]
    K, Mp = fa.lit_var.shape
    for fixed, R in ((True, got[0]), (False, got[1])):
        if R is not None:
            assert fc.fused_smem_bytes(fa, fixed, R) <= LIMIT
            assert R == 32 or fc.fused_smem_bytes(fa, fixed, 2 * R) > LIMIT
        else:
            assert fc.fused_smem_bytes(fa, fixed, 1) > LIMIT
    for fixed, R in ((True, got[2]), (False, got[3])):
        assert sc.stream_smem_bytes(fa.n_vars_padded, fixed, R) <= LIMIT
        assert R == 32 or sc.stream_smem_bytes(fa.n_vars_padded, fixed, 2 * R) > LIMIT


@pytest.mark.parametrize("lanes, B, want", [
    (32, 10240, 16),  # n1k: 320 tiles leave a third wave of 56 on 132 SMs; 640 fill 97%
    (32, 16384, 32),  # hard.cnf: 512 tiles, 97%
    (8, 10240, 8),  # local n=4096: 1280 tiles, 97%
    (8, 4096, 8),  # uf250: 512 tiles
    (32, 1000, 8),  # 32 tiles fill a quarter of the card; 125 fill 95%
    (32, 1, 32),  # one tile at any R: the largest
    (1, 37, 1),
])
def test_a_launch_halves_lanes_for_a_ragged_last_wave(lanes, B, want):
    assert fc.wave_lanes(lanes, B, 132) == want
    assert fc.launch_lanes(lanes, B, "cpu") == lanes


def test_footprints_word_for_word():
    """The footprints are the kernel's carve-up (csrc/ode_lanes.cuh): 3 + 3R
    lane words, then the tables and R lanes of state (B1), or R lanes of the
    v window and hv (B2); B2's device scratch is xs, xl and the
    contributions, plus dxs1, dxl1 and fv when adaptive."""
    fa = formula_arrays_from_numpy(jcompile(jnormalize(jrandom_ksat(30, 80, seed=0))[1]))
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, int((fa.lit_mask > 0).sum())
    for R in (1, 8, 32):
        assert fc.fused_smem_bytes(fa, True, R) == 4 * (
            3 + 3 * R + K * Mp + Np + 1 + nnz + R * (Np + 2 * Mp + K * Mp))
        assert fc.fused_smem_bytes(fa, False, R) == 4 * (
            3 + 3 * R + K * Mp + Np + 1 + nnz + R * (3 * Np + 4 * Mp + K * Mp))
        assert sc.stream_smem_bytes(Np, True, R) == 4 * (3 + 3 * R + R * Np)
        assert sc.stream_smem_bytes(Np, False, R) == 4 * (3 + 3 * R + 2 * R * Np)
        assert sc.stream_scratch_floats(Np, Mp, nnz, True, R) == R * (2 * Mp + nnz)
        assert sc.stream_scratch_floats(Np, Mp, nnz, False, R) == R * (4 * Mp + nnz + Np)


@pytest.mark.parametrize("name", ["widths 2,3,5", "widths 2,3,5 bucketed", "hard.cnf",
                                  "n1k preprocessed"])
def test_clause_segments_cover_the_clauses(formulas, name):
    """The segments cut [0, Mp) in order; every clause's slots lie below its
    segment's width, and from m_pad on a segment holds padded clauses only."""
    fa = formulas[name]
    K, Mp = fa.lit_var.shape
    seg = fc.clause_segments(fa)
    assert seg.dtype == np.int32 and seg.shape[1] == 4
    assert seg[0, 0] == 0 and seg[-1, 1] == Mp and (seg[1:, 0] == seg[:-1, 1]).all()
    on = fa.lit_mask > 0
    for m0, m1, w, m_pad in seg:
        assert 1 <= w <= K and m0 <= m_pad <= m1
        assert not on[w:, m0:m1].any()
        assert not on[:, m_pad:m1].any()
        assert m_pad == m0 or on[:, m_pad - 1].any()
    if fa.bucket_slices and len(fa.bucket_slices) > 1:
        assert [tuple(s[:2]) for s in seg.tolist()] == [s[:2] for s in fa.bucket_slices]


def test_slot_positions_invert_the_csr_lists(formulas):
    fa = formulas["widths 2,3,5 bucketed"]
    t = fc.chunk_tables(fa)
    pos = sc.slot_positions(t)
    np.testing.assert_array_equal(pos[t.occ_slot], np.arange(t.occ_slot.size))
    np.testing.assert_array_equal(pos < 0, t.lit_code < 0)


def _padded(state, B, R):
    """The batch as the kernels lay it out: tiles of R, the last one padded
    with done rows (zero state, as the kernel fills its padded lanes)."""
    fields = [tile(t, R, fill=(True if t.dtype == torch.bool else 0)) for t in state]
    return ODEState(*(untile(t, n_tiles(B, R) * R) for t in fields))


@pytest.mark.parametrize("B", [1, 7, 33, 1000])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_ragged_tiles_never_change_a_real_row(B, mode):
    """At ragged B the kernels pad the last tile with done lanes; each row is
    computed on its own, so the plain version over the padded batch gives
    every real row exactly as over the batch (both wrappers' R), and the
    tiling round trip is the identity."""
    fa = formula_arrays_from_numpy(jcompile(jnormalize(jrandom_ksat(30, 80, seed=3))[1]))
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None)
    state = state_from_numpy(*numpy_state(fa, B, B), device="cpu")
    for make in (fc.make_fused_chunk, sc.make_stream_chunk):
        fn = make(fa, 0.05, ode, 6, "cpu")
        R = fn.spec.lanes
        for t in state:
            assert torch.equal(untile(tile(t, R), B), t)
        whole = fn(state)
        padded = fn(_padded(state, B, R))
        for a, b in zip(whole, padded):
            assert torch.equal(a, b[:B])


@pytest.mark.parametrize("B", [1, 7, 33])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_plain_matches_pallas_at_ragged_batches(B, mode):
    """Both wrappers' CPU path (the plain version) against the TPU kernels
    in interpret mode, at batches that leave the last tile ragged."""
    fa = jcompile(jnormalize(jrandom_ksat(30, 80, seed=4))[1])
    kw = dict(step_size=0.02 if mode == "fixed" else None)
    arrays = numpy_state(fa, B, 40 + B)
    tfa = formula_arrays_from_numpy(fa)
    for jmake, make in ((jax_fused_chunk, fc.make_fused_chunk),
                        (jax_stream_chunk, sc.make_stream_chunk)):
        jout = jmake(fa, 0.05, JODE(**kw), 8, interpret=True)(jax_state(arrays))
        tout = make(tfa, 0.05, ODEConfig(**kw), 8, "cpu")(state_from_numpy(*arrays,
                                                                            device="cpu"))
        assert_states_close(tout, jout, dt_rtol=2e-4, **F32)
