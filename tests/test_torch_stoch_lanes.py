"""The lane-tile layout of the stochastic chunk kernels B3 and B4
(ops/stoch_chunk.py) on the CPU.

Both kernels run a tile of R chains a CTA, a chain on one lane of each
thread group (csrc/stoch_chunk.cu ``stoch_lanes_kernel``), R chosen per
formula from its shared-memory footprint. What the CPU can check is held
here:

- R for the formulas the stoch main path drives, at their compiled shapes
  (hard.cnf, easy.cnf and the n=1k instance preprocessed, and the wide
  bucketed planted 5-SAT instance), against 232,448 bytes;
- the footprints word for word, and at R = 1 equal to the one-CTA-a-chain
  kernels' (written out below), so neither gate narrows;
- the per-launch halving of R for a ragged last wave of tiles, and the
  threads a CTA takes;
- the host-side variable order covers every variable exactly once,
  longest occurrence list first, and the lists in that order are each
  variable's in CSR order;
- a ragged batch: the last tile's padded lanes are done rows and each chain
  is computed on its own, so the plain version over the padded batch (the
  real batch's PRNG blocking) equals it over the batch, row for row.

The plain version against the JAX package's Pallas kernels at ragged
batches is tests/test_torch_stoch.py's ``test_plain_matches_pallas``; the
kernels themselves run on the card (tests/test_torch_cuda.py), where they
equal the plain version exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.utils.generate import random_ksat as jrandom_ksat  # noqa: E402
from odesat_tpu_torch.cnf import normalize_cnf_variables, parse_dimacs_file  # noqa: E402
from odesat_tpu_torch.interop import (  # noqa: E402
    formula_arrays_from_numpy,
    stoch_state_from_numpy,
)
from odesat_tpu_torch.models.ode import compile_for_config  # noqa: E402
from odesat_tpu_torch.models.stoch import StochState  # noqa: E402
from odesat_tpu_torch.ops import fused_chunk as fc  # noqa: E402
from odesat_tpu_torch.ops import stoch_chunk as sc  # noqa: E402
from odesat_tpu_torch.preprocess import preprocess_formula  # noqa: E402
from odesat_tpu_torch.utils.config import SolverConfig  # noqa: E402
from odesat_tpu_torch.utils.generate import random_ksat  # noqa: E402

LIMIT = 232448
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _for_config(formula):
    """The layout ``stoch`` compiles a formula to (the ODE engine's rule)."""
    return compile_for_config(normalize_cnf_variables(formula)[1], SolverConfig())


def _preprocessed(formula):
    return _for_config(preprocess_formula(formula, 7.0)[0])


FORMULAS = {
    "hard.cnf": lambda: _for_config(parse_dimacs_file(os.path.join(DATA, "hard.cnf"))),
    "easy.cnf preprocessed": lambda: _preprocessed(
        parse_dimacs_file(os.path.join(DATA, "easy.cnf"))),
    "n1k preprocessed": lambda: _preprocessed(random_ksat(1000, 4300, k=3, seed=7,
                                                          planted=True)),
    "planted 5-SAT n=2000 preprocessed": lambda: _preprocessed(
        random_ksat(2000, 8000, k=5, seed=11, planted=True)),
}

# (B3, B4) chains a CTA; None: past the gate
LANES = {
    "hard.cnf": (32, 32),
    "easy.cnf preprocessed": (32, 32),
    "n1k preprocessed": (None, 8),
    "planted 5-SAT n=2000 preprocessed": (None, 4),
}


def _old_fused_bytes(fa):
    """B3's footprint before the lane tiles: one chain a CTA, the tables,
    the chain's xl (int32) and v (bytes)."""
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, int((fa.lit_mask > 0).sum())
    return 4 * (K * Mp + (Np + 1) + nnz + Mp) + Np


def _old_stream_bytes(fa):
    """B4's footprint before the lane tiles: one chain's xl and v."""
    return 4 * fa.n_clauses_padded + fa.n_vars_padded


@pytest.fixture(scope="module")
def formulas():
    return {name: make() for name, make in FORMULAS.items()}


def test_the_wide_formula_is_bucketed(formulas):
    fa = formulas["planted 5-SAT n=2000 preprocessed"]
    assert fa.lit_var.shape[0] > 8 and len(fc.clause_segments(fa)) > 1


@pytest.mark.parametrize("name", list(FORMULAS))
def test_lanes_and_footprint(formulas, name):
    """The chains a CTA each formula gets: the largest power of two up to
    32 whose footprint fits 232,448 bytes."""
    fa = formulas[name]
    got = (sc.stoch_lanes(fa, "fused"), sc.stoch_lanes(fa, "stream"))
    assert got == LANES[name]
    for R, footprint in zip(got, (sc.stoch_fused_smem_bytes, sc.stoch_stream_smem_bytes)):
        if R is None:
            assert footprint(fa, 1) > LIMIT
        else:
            assert footprint(fa, R) <= LIMIT
            assert R == 32 or footprint(fa, 2 * R) > LIMIT


@pytest.mark.parametrize("name", list(FORMULAS))
def test_gates_are_no_narrower(formulas, name):
    """At one chain the footprints are the one-CTA-a-chain kernels' word for
    word, so each gate takes exactly the formulas it took."""
    fa = formulas[name]
    assert sc.stoch_fused_smem_bytes(fa, 1) == sc.stoch_fused_smem_bytes(fa) == \
        _old_fused_bytes(fa)
    assert sc.stoch_stream_smem_bytes(fa, 1) == sc.stoch_stream_smem_bytes(fa) == \
        _old_stream_bytes(fa)
    assert sc.stoch_fused_supported(fa) == (_old_fused_bytes(fa) <= LIMIT)
    assert sc.stoch_stream_supported(fa) == (_old_stream_bytes(fa) <= LIMIT)


def test_footprints_word_for_word():
    """The carve-up of ``csrc/stoch_chunk.cu``: two lane-flag words past one
    lane, the tables (B3), then R lanes of xl (int32) and v (bytes)."""
    fa = formula_arrays_from_numpy(jcompile(jnormalize(jrandom_ksat(30, 80, seed=0))[1]))
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, int((fa.lit_mask > 0).sum())
    for R in (1, 2, 8, 32):
        flags = 0 if R == 1 else 2
        assert sc.stoch_fused_smem_bytes(fa, R) == 4 * (
            flags + K * Mp + Np + 1 + nnz + R * Mp) + R * Np
        assert sc.stoch_stream_smem_bytes(fa, R) == 4 * (flags + R * Mp) + R * Np


@pytest.mark.parametrize("lanes, B, want", [
    (8, 8192, 8),  # n1k: 1024 tiles, 97% of eight waves on 132 SMs
    (32, 16384, 32),  # hard.cnf: 512 tiles
    (4, 1024, 4),  # planted 5-SAT at phase 10's batch: 256 tiles
    (32, 4096, 32),  # easy.cnf: 128 tiles, one wave
    (32, 1000, 8),  # 32 tiles fill a quarter of the card; 125 fill 95%
    (8, 1100, 2),  # 138 tiles fill 52% of two waves, 275 69% of three, 550 83% of five
    (32, 1, 32),  # one tile at any R: the largest
])
def test_a_launch_halves_lanes_for_a_ragged_last_wave(lanes, B, want):
    assert fc.wave_lanes(lanes, B, 132) == want
    assert fc.launch_lanes(lanes, B, "cpu") == lanes


@pytest.mark.parametrize("name, kernel, B, want", [
    ("hard.cnf", "fused", 16384, 512),  # 42 KB a CTA: five share an SM; 512 tiles
    ("hard.cnf", "stream", 16384, 512),
    ("hard.cnf", "fused", 1000, 512),  # 125 tiles of 8, but four clauses a group at most
    ("easy.cnf preprocessed", "fused", 4096, 1024),  # 128 tiles: an SM each
    ("n1k preprocessed", "stream", 8192, 1024),  # one CTA fills an SM's shared memory
    ("planted 5-SAT n=2000 preprocessed", "stream", 1024, 1024),
])
def test_threads_a_cta(formulas, name, kernel, B, want):
    """The main path's launches on 132 SMs: 1024 threads where a tile has an
    SM to itself, else 512, and no more than give a group four clauses; the
    footprint is the kernel's at the launch's R."""
    fa = formulas[name]
    R = fc.wave_lanes(sc.stoch_lanes(fa, kernel), B, 132)
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, int((fa.lit_mask > 0).sum())
    smem = sc.lanes_smem_bytes(kernel == "fused", Np, Mp, K, nnz, R)
    assert smem == (sc.stoch_fused_smem_bytes if kernel == "fused"
                    else sc.stoch_stream_smem_bytes)(fa, R)
    assert sc.stoch_threads(R, smem, -(-B // R), 132, Np, Mp) == want


@pytest.mark.parametrize("name", list(FORMULAS))
def test_var_order_covers_every_variable_once(formulas, name):
    """The variable positions' order is a permutation of the padded
    variables, longest occurrence list first, ties by index."""
    t = fc.chunk_tables(formulas[name])
    order = sc.var_order(t)
    assert order.dtype == np.int32 and order.shape == (t.Np,)
    np.testing.assert_array_equal(np.sort(order), np.arange(t.Np))
    counts = np.diff(t.occ_ptr)[order]
    assert (counts[:-1] >= counts[1:]).all()
    tie = counts[:-1] == counts[1:]
    assert (order[:-1][tie] < order[1:][tie]).all()


@pytest.mark.parametrize("name", list(FORMULAS))
def test_position_lists_are_the_variables_lists(formulas, name):
    """The lists the kernels walk: position p's is variable order[p]'s
    clause columns in CSR order, so the sums keep the plain version's
    order."""
    t = fc.chunk_tables(formulas[name])
    order = sc.var_order(t)
    ptr, clauses = sc.position_lists(t, order)
    assert ptr.dtype == clauses.dtype == np.int32 and clauses.shape == t.occ_slot.shape
    for p, i in enumerate(order):
        np.testing.assert_array_equal(clauses[ptr[p]:ptr[p + 1]],
                                      t.occ_slot[t.occ_ptr[i]:t.occ_ptr[i + 1]] % t.Mp)


@pytest.mark.parametrize("name", ["hard.cnf", "n1k preprocessed"])
def test_spec_carries_what_the_kernels_read(formulas, name):
    fa = formulas[name]
    spec = sc.stoch_spec(fa, "cpu")
    assert (spec.fused_lanes, spec.stream_lanes) == LANES[name]
    np.testing.assert_array_equal(spec.segments.numpy(), fc.clause_segments(fa))
    t = fc.chunk_tables(fa)
    order = sc.var_order(t)
    np.testing.assert_array_equal(spec.var_order.numpy(), order)
    for got, want in zip((spec.pos_ptr, spec.pos_clause), sc.position_lists(t, order)):
        np.testing.assert_array_equal(got.numpy(), want)


def _padded(state, B, R):
    """The batch as a launch lays it out: tiles of R, the last one padded
    with done rows of zero state."""
    n = -(-B // R) * R - B
    return StochState(torch.cat([state.v, state.v.new_zeros(n, state.v.shape[1])]),
                      torch.cat([state.xl, state.xl.new_zeros(n, state.xl.shape[1])]),
                      torch.cat([state.done, state.done.new_ones(n)]))


@pytest.mark.parametrize("B", [1, 7, 33, 1000])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_ragged_tiles_never_change_a_real_row(B, bf16):
    """At ragged B a launch pads the last tile with done lanes, which read
    and write nothing; every chain draws from its own (block, row) of the
    batch's PRNG blocking, so the plain version over the padded batch gives
    every real row exactly as over the batch, at every R."""
    fa = formula_arrays_from_numpy(jcompile(jnormalize(jrandom_ksat(30, 120, seed=3))[1]))
    spec = sc.stoch_spec(fa, "cpu")
    rng = np.random.default_rng(B)
    state = stoch_state_from_numpy(rng.random((B, fa.n_vars_padded)) < 0.5,
                                   rng.integers(1, 3000, (B, fa.n_clauses_padded)),
                                   np.zeros(B, bool), "cpu")
    Bb = sc.traj_block(B)
    whole = sc.stoch_chunk_plain(state, spec, 6, 99, Bb, bf16)
    assert (whole.v != state.v).any(), "no flips: the case tests nothing"
    for R in (4, 32):
        padded = sc.stoch_chunk_plain(_padded(state, B, R), spec, 6, 99, Bb, bf16)
        for a, b in zip(whole, padded):
            assert torch.equal(a, b[:B])
