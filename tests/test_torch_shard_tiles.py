"""The per-step clause-shard kernels B5 (ODE, odesat_tpu_torch/ops/
shard_stream.py) and B8 (stoch, ops/stoch_chunk.py) on tiled buffers, on
the CPU, where their tiled entries run the plain versions.

Both kernels run B6's and B9's device code over the tile layout of
``ops/tiles.py`` (32 trajectories or chains a tile), and their
``--shard-chunk off`` runners keep the rows tiled for a chunk. Held here:

* the tiled plain entries against the JAX package's Pallas kernels in
  interpret mode, row for row, at ragged B = 1, 7, 33 (a part-filled last
  tile): B5's ``rhs`` per shard at S=2 (dxs/dxl rtol 1e-5 / atol 1e-6, dv
  summed over shards rtol 1e-4 / atol 1e-5, sat equal: the JAX test's own
  tolerances), one ``fixed`` and one adaptive (``rhs`` + ``second``) step
  at S=1 (rtol 2e-4 / atol 2e-5, done exactly), bf16 to rtol 1e-2 / atol
  1e-2 (tests/test_torch_fused.py's reason: the two round at other
  points); B8 exactly (integer weights in f32), f32 and bf16, with unit
  clauses;
* the tiled runners (ODE fixed and adaptive, stoch) against the row-major
  step loop they replace, written out here as it ran before, and against
  the B6 and B9 runners: bit for bit;
* the uniforms drawn in tile order against ``tile(uniform01(...))``, and
  drawn in place into held buffers (``TiledUniforms``) against both;
* the tiled plain entries row for row, whatever the padding rows hold;
* the gates at the boundary Np: exactly what they took before;
* the runners' tiling in the caller's own storage (``tile_``, ``untile_``
  and ``Tiles``) bit for bit with ``tile`` and ``untile``: float32, int32
  and bool fields of 1, 2 and 3 dimensions, full and ragged batches,
  staging of 1 tile up to every tile; a full batch's tiles share the
  input's storage, a ragged, non-contiguous or aliased field takes the
  held buffers.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from odesat_tpu.cnf import normalize_cnf_variables  # noqa: E402
from odesat_tpu.cnf.formula import CNFFormula as JCNF  # noqa: E402
from odesat_tpu.models import ode as jode  # noqa: E402
from odesat_tpu.ops import shard_stream as jss  # noqa: E402
from odesat_tpu.ops import stoch_pallas as jsp  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.generate import random_ksat  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy, state_from_numpy  # noqa: E402
from odesat_tpu_torch.models.loop import copy_state  # noqa: E402
from odesat_tpu_torch.models.ode import ODEState  # noqa: E402
from odesat_tpu_torch.models.stoch import StochState  # noqa: E402
from odesat_tpu_torch.ops import shard_chunk as sch  # noqa: E402
from odesat_tpu_torch.ops import shard_stream as ss  # noqa: E402
from odesat_tpu_torch.ops import stoch_chunk as sc  # noqa: E402
from odesat_tpu_torch.ops.fused_chunk import SMEM_LIMIT_BYTES, _clamp  # noqa: E402
from odesat_tpu_torch.ops.tiles import (  # noqa: E402
    TILE,
    Tiles,
    in_place,
    n_tiles,
    tile,
    tile_,
    untile,
    untile_,
)
from odesat_tpu_torch.parallel import sharded  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from tests.torch_parity import port_formula  # noqa: E402

ZETA = 0.001
RAGGED = (1, 7, 33)
F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _mixed(seed=11, widths=((2, 60), (3, 260), (4, 60)), n=160):
    """Width buckets (``(k, count)`` clauses of each width) over ``n``
    variables, normalized, as the JAX package's formula."""
    clauses = []
    for k, m in widths:
        clauses += random_ksat(n, m, k=k, seed=seed + k).clauses
    return normalize_cnf_variables(JCNF(clauses, n))[1]


def _ode_inputs(fa, B, seed):
    rng = np.random.default_rng(seed)
    Np, Mp = fa.n_vars_padded, fa.n_clauses_padded
    v = rng.uniform(-1, 1, (B, Np)).astype(np.float32)
    xs = (np.broadcast_to(fa.xs_init, (B, Mp)) + 0.1).astype(np.float32)
    xl = rng.uniform(1.0, 3.0, (B, Mp)).astype(np.float32)
    dt = np.full(B, 0.05, np.float32)
    done = np.zeros(B, bool)
    done[1::3] = True
    return v, xs, xl, dt, done


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ------------------------------------------------ B5 against the JAX kernel


@pytest.mark.parametrize("B", RAGGED)
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
def test_tiled_rhs_matches_pallas_per_shard(B, rigidity):
    jfa, jplan = jss.compile_stream_sharded(_mixed(), 2)
    tfa = formula_arrays_from_numpy(jfa)
    v, xs, xl, _, _ = _ode_inputs(jfa, B, seed=B)
    jrhs = jss.make_stream_shard_rhs(jplan, ZETA, JODE(step_size=0.01, rigidity=rigidity),
                                     interpret=True)
    ode = ODEConfig(step_size=0.01, rigidity=rigidity)
    ml, Np = jplan.mp_local, jfa.n_vars_padded
    dv_j = np.zeros((B, Np), np.float64)
    dv_t = np.zeros_like(dv_j)
    for s in range(2):
        seg = slice(s * ml, (s + 1) * ml)
        jdv, jdxs, jdxl, jsat = jrhs(
            jnp.asarray(v), jnp.asarray(xs[:, seg]), jnp.asarray(xl[:, seg]),
            jnp.asarray(jplan.planes[s]), jnp.asarray(jplan.lo[s]), jnp.asarray(jplan.bias[s]),
            jnp.asarray(jfa.clause_mask[seg]))
        spec = ss.shard_spec(tfa, ZETA, ode, "cpu", s)
        acc, dxs, dxl = ss.shard_stream_tiled("rhs", spec, tile(_t(v)),
                                              tile(_t(xs[:, seg]), fill=0.5),
                                              tile(_t(xl[:, seg]), fill=1.0))
        assert acc.shape == (n_tiles(B), Np + 1, TILE)
        np.testing.assert_allclose(untile(dxs, B).numpy(), np.asarray(jdxs), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(untile(dxl, B).numpy(), np.asarray(jdxl), rtol=1e-5, atol=1e-6)
        acc = untile(acc, B).numpy()
        np.testing.assert_array_equal(acc[:, Np] == 0, np.asarray(jsat))
        dv_j += np.asarray(jdv, np.float64)
        dv_t += acc[:, :Np].astype(np.float64)
    np.testing.assert_allclose(dv_t, dv_j, rtol=1e-4, atol=1e-5)


STEP_CASES = [(B, mode, "paper" if B == 7 else "reference", "float32")
              for B in RAGGED for mode in ("fixed", "adaptive")]
STEP_CASES += [(7, mode, "reference", "bfloat16") for mode in ("fixed", "adaptive")]


@pytest.mark.parametrize("B,mode,rigidity,matmul_dtype", STEP_CASES)
def test_tiled_step_matches_pallas_at_s1(B, mode, rigidity, matmul_dtype):
    """One step of the clause step on tiled state (``step.tiled``): B5's
    ``fixed`` mode, or its ``rhs`` and ``second`` modes around the torch dt
    control; against the JAX step with ``clause_axis=None``."""
    jfa, _ = jss.compile_stream_sharded(_mixed(seed=17), 1)
    tfa = formula_arrays_from_numpy(jfa)
    kw = dict(step_size=0.01 if mode == "fixed" else None, rigidity=rigidity,
              matmul_dtype=matmul_dtype)
    arrays = _ode_inputs(jfa, B, seed=23 + B)
    jstep = jss.make_fused_clause_step(jfa, ZETA, JODE(**kw), interpret=True)
    jout = jstep(jode.ODEState(*(jnp.asarray(a) for a in arrays)), jode.formula_device(jfa))
    step = ss.make_fused_clause_step(tfa, ZETA, ODEConfig(**kw), device="cpu")
    tiled = step.tiled(ss.tile_state(state_from_numpy(*arrays, device="cpu")))
    assert tiled.v.shape == (n_tiles(B), jfa.n_vars_padded, TILE)
    tout = ss.untile_state(tiled, B)
    tol = F32 if matmul_dtype == "float32" else BF16
    for name in ("v", "xs", "xl", "dt"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   err_msg=name, **tol)
    np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))


# ------------------------------------------------ B8 against the JAX kernel


@pytest.mark.parametrize("B", RAGGED)
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_tiled_stoch_eval_matches_pallas(B, mm):
    """B8's tiled plain entry on both shards of a formula with unit clauses:
    the partials, the new weights (a done chain's unchanged) and the sat
    flag exactly as the JAX kernel gives them."""
    formula = _mixed(seed=3, widths=((1, 6), (2, 60), (3, 200), (5, 60)), n=60)
    jfa, jplan = jss.compile_stream_sharded(formula, 2)
    assert jfa.min_width == 1
    tfa = formula_arrays_from_numpy(jfa)
    ev = jsp.make_stoch_shard_eval(jfa, interpret=True, matmul_dtype=mm)
    sbias, nsign = jsp.stoch_shard_arrays(jfa)
    rng = np.random.default_rng(B)
    Np, ml = jfa.n_vars_padded, jplan.mp_local
    v = rng.random((B, Np)) < 0.5
    xl = rng.integers(1, 3001, (B, jfa.n_clauses_padded)).astype(np.int32)
    active = rng.random(B) < 0.75
    for s in range(2):
        seg = slice(s * ml, (s + 1) * ml)
        jt, ju, jx, js = ev(jnp.asarray(v, jnp.float32), jnp.asarray(xl[:, seg], jnp.float32),
                            jnp.asarray(active), jnp.asarray(jplan.planes[s]),
                            jnp.asarray(jplan.lo[s]), jnp.asarray(sbias[s]),
                            jnp.asarray(nsign[s]), jnp.asarray(jfa.clause_mask[seg]))
        tev = sc.make_stoch_shard_eval(tfa, "cpu", s, mm)
        xl_t, acc = tev.tiled(tile(_t(v)), tile(_t(xl[:, seg]), fill=1),
                              tile(_t(~active), fill=True))
        acc = untile(acc, B).numpy()
        np.testing.assert_array_equal(acc[:, :Np], np.asarray(jt))
        np.testing.assert_array_equal(acc[:, Np:2 * Np], np.asarray(ju))
        np.testing.assert_array_equal(acc[:, 2 * Np] == 0, np.asarray(js))
        np.testing.assert_array_equal(untile(xl_t, B).numpy(), np.asarray(jx).astype(np.int32))


# ------------------------------------------ the runners on tiled buffers


def _row_major_clause_loop(fa, ode, state, steps):
    """The ``--shard-chunk off`` ODE step loop as it ran on rows, each step
    cloning nothing and calling B5's row-major plain versions (S=1)."""
    spec = ss.shard_spec(fa, ZETA, ode, "cpu")
    v, xs, xl, dt, done = state

    def clamp_v(x):
        return _clamp(x, -1.0, 1.0)

    for _ in range(steps):
        if ode.step_size is not None:
            dt_eff = torch.where(done, 0.0, v.new_tensor(float(ode.step_size)))
            dv, xs, xl, sat = ss.shard_fixed(v, dt_eff, xs, xl, spec)
            v = clamp_v(v + dt_eff.unsqueeze(1) * dv)
            done = done | sat
            continue
        dv1, dxs1, dxl1, sat = ss.shard_rhs(v, xs, xl, spec)
        advance = ~done & ~sat
        dt_c = dt.unsqueeze(1)
        half = 0.5 * dt_c
        fv = clamp_v(v + dt_c * dv1)
        hv = clamp_v(v + half * dv1)
        dv2, xs, xl, err_sl = ss.shard_second(hv, dt, advance, xs, xl, dxs1, dxl1, spec)
        tv = clamp_v(hv + half * dv2)
        err = torch.maximum(err_sl, (fv - tv).abs().amax(dim=1))
        ratio = err.new_tensor(float(ode.tolerance)) / err.clamp_min(1e-30)
        new_dt = _clamp(dt * torch.sqrt(ratio), 2.0**-7, 1000.0)
        v = torch.where(advance.unsqueeze(1), tv, v)
        dt = torch.where(advance, new_dt, dt)
        done = done | sat
    return ODEState(v, xs, xl, dt, done)


@pytest.mark.parametrize("B", RAGGED)
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_tiled_runner_equals_row_major_loop_and_b6(mode, B):
    """B5's runner, tiled once a chunk, equals the row-major step loop it
    replaces and the B6 chunk bit for bit, through steps in which rows
    finish; each runner returns its input's storage (it consumes its
    input, as JAX's donated state), and the row-major loop writes nothing
    of its own."""
    fa, _ = ss.compile_stream_sharded(port_formula(_mixed(seed=8)), 1)
    ode = ODEConfig(step_size=0.02) if mode == "fixed" else ODEConfig(tolerance=1e-3)
    arrays = _ode_inputs(fa, B, seed=5)
    state = state_from_numpy(*arrays, device="cpu")
    inputs = copy_state(state), copy_state(state)
    out = ss.make_single_device_runner(fa, ZETA, ode, 9, "cpu")(inputs[0])
    ref = _row_major_clause_loop(fa, ode, state, 9)
    b6 = sch.make_shard_chunk(fa, ZETA, ode, 9, None, "cpu")(inputs[1])
    for name, a, b, c in zip(state._fields, out, ref, b6):
        assert torch.equal(a, b) and torch.equal(a, c), name
    for res, inp in zip((out, b6), inputs):
        assert all(a.data_ptr() == b.data_ptr() for a, b in zip(res, inp))
    for a, b in zip(state, arrays):
        np.testing.assert_array_equal(a.numpy(), b)


def _row_major_stoch_loop(fa, chunks, chunk_steps, seed, B):
    """The ``--shard-chunk off`` stoch path as it ran on rows: B8's row-major
    plain version, then the flips from ``uniform01`` in torch (S=1)."""
    ev = sc.make_stoch_shard_eval(fa, "cpu", 0)
    gen = sharded.row_generator(seed, None)
    v = torch.zeros((B, fa.n_vars_padded), dtype=torch.bool)
    xl = torch.ones((B, fa.n_clauses_padded), dtype=torch.int32)
    done = torch.zeros(B, dtype=torch.bool)
    chains = torch.arange(B, dtype=torch.int64)
    for _ in range(chunks):
        chunk_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
        for t in range(chunk_steps):
            total, unsat, xl, allsat = ev(v, xl, ~done)
            u = sc.uniform01(chunk_seed, chains, sc.traj_block(B), t, fa.n_vars_padded)
            v = torch.where((~done).unsqueeze(1) & (u * total < unsat), ~v, v)
            done = done | allsat
    return v, xl, done


@pytest.mark.parametrize("B", RAGGED)
def test_tiled_stoch_runner_equals_row_major_loop_and_b9(B):
    fa, _ = ss.compile_stream_sharded(port_formula(_mixed(seed=9, widths=((3, 420),), n=96)), 1)
    off = sharded.run_stoch_clause(None, "cpu", fa, 2, 7, 3, "float32", B, "off")
    ref = _row_major_stoch_loop(fa, 2, 7, 3, B)
    b9 = sharded.run_stoch_clause(None, "cpu", fa, 2, 7, 3, "float32", B, "auto")
    for a, b, c in zip(off, ref, b9):
        np.testing.assert_array_equal(a, b.numpy())
        np.testing.assert_array_equal(a, c)
    assert off[0].any() and off[1].max() > 1  # flips happened, weights grew


@pytest.mark.parametrize("B", [1, 33, 64])
def test_uniforms_in_tile_order_equal_the_tiled_rows(B):
    Np, Bb, G = 96, sc.traj_block(B), n_tiles(B)
    u = sc.uniform01_tiled(12345, G, Bb, 3, Np, "cpu")
    assert u.shape == (G, Np, TILE) and u.dtype == torch.float32
    rows = sc.uniform01(12345, torch.arange(B, dtype=torch.int64), Bb, 3, Np)
    assert torch.equal(untile(u, B), rows)
    assert torch.equal(u, tile(sc.uniform01(12345, torch.arange(G * TILE, dtype=torch.int64),
                                            Bb, 3, Np)))
    # B8's runner draws them in place into held buffers: the same bits at
    # every seed and step, the buffer overwritten draw after draw
    held = sc.TiledUniforms(G, Bb, Np, "cpu")
    for seed, step in ((12345, 3), (2**31 - 2, 0), (7, 70000)):
        want = sc.uniform01_tiled(seed, G, Bb, step, Np, "cpu")
        got = held.draw(seed, step)
        assert torch.equal(got, want) and got.data_ptr() == held.u.data_ptr()


# ------------------------------------------ the tiled entries, row for row


@pytest.mark.parametrize("mode", ["rhs", "fixed", "second"])
def test_tiled_plain_entry_is_row_for_row(mode):
    """B5's tiled plain entry on buffers whose padding rows hold other
    values equals the row-major plain version on the real rows."""
    fa, _ = ss.compile_stream_sharded(port_formula(_mixed(seed=4)), 1)
    spec = ss.shard_spec(fa, ZETA, ODEConfig(step_size=0.01), "cpu")
    B, rng = 9, np.random.default_rng(6)
    Np, Mp = fa.n_vars_padded, fa.n_clauses_padded

    def put(*shape, lo=-1.0, hi=1.0):
        return _t(rng.uniform(lo, hi, shape).astype(np.float32))

    rows = dict(v=put(B, Np), xs=put(B, Mp, lo=0.01, hi=0.99), xl=put(B, Mp, lo=1, hi=9),
                dt=put(B, lo=0.0, hi=0.05), adv=_t(rng.random(B) < 0.6), dxs1=put(B, Mp),
                dxl1=put(B, Mp))
    keys = {"rhs": ("v", "xs", "xl"), "fixed": ("v", "dt", "xs", "xl"),
            "second": ("v", "dt", "adv", "xs", "xl", "dxs1", "dxl1")}[mode]
    plain = {"rhs": ss.shard_rhs_plain, "fixed": ss.shard_fixed_plain,
             "second": ss.shard_second_plain}[mode]
    ref = plain(*(rows[k] for k in keys), spec)
    tiled = {k: tile(t, fill=True if k == "adv" else 7.0) for k, t in rows.items()
             if k in keys}
    out = [untile(t, B) for t in ss.shard_stream_tiled(mode, spec, **tiled)]
    if mode != "second":  # (dv | 1 - sat) packed
        out = [out[0][:, :Np], *out[1:], out[0][:, Np] == 0]
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_tiled_entries_refuse_other_devices():
    fa, _ = ss.compile_stream_sharded(port_formula(_mixed(seed=4)), 1)
    spec = ss.shard_spec(fa, ZETA, ODEConfig(step_size=0.01), "cpu")
    meta = torch.empty((1, fa.n_vars_padded, TILE), device="meta")
    with pytest.raises(ValueError, match="no shard RHS path"):
        ss.shard_stream_tiled("rhs", spec, meta, meta, meta)
    ev = sc.make_stoch_shard_eval(fa, "cpu", 0)
    with pytest.raises(ValueError, match="no stoch shard path"):
        ev.tiled(meta, meta, meta)
    # the CUDA entries refuse a spec on the CPU instead of falling back
    with pytest.raises(ValueError, match="CUDA tensors"):
        sc.stoch_shard_eval_cuda(meta, meta, meta, ev.spec, False)


# ------------------------------------------------ the gates at the boundary


@pytest.mark.parametrize("Np", [57984, 58048, 58080, 58081, 58112])
@pytest.mark.parametrize("Mp", [128, 43776])
def test_ode_gate_is_unchanged_at_the_boundary(Np, Mp):
    """B5's (and so B6's) gate takes exactly the formulas the
    one-CTA-a-trajectory placement took: v (f32) resident beside 32 words
    of reduction scratch, the clause words spilling where they do not fit,
    so the placement held exactly when v and the scratch fit."""
    before = 4 * (Np + 32) <= SMEM_LIMIT_BYTES
    assert ss.v_fits_one_cta(Np) == before == (Np <= 58080)
    plan = SimpleNamespace(n_shards=1, mp_local=Mp)
    fa = SimpleNamespace(shard_plan=plan, min_width=3, n_vars_padded=Np)
    assert ss.stream_shard_supported(fa) == before
    assert not ss.stream_shard_supported(fa, plan, "float64")
    assert not ss.stream_shard_supported(SimpleNamespace(**{**vars(fa), "min_width": 1}))


@pytest.mark.parametrize("Np", [SMEM_LIMIT_BYTES - 128, SMEM_LIMIT_BYTES,
                                SMEM_LIMIT_BYTES + 1, SMEM_LIMIT_BYTES + 128])
def test_stoch_gate_is_unchanged_at_the_boundary(Np):
    """B8's and B9's gate: a shard plan and a chain's v bytes within one
    CTA's shared memory, unit clauses taken."""
    fa = SimpleNamespace(shard_plan=object(), min_width=1, n_vars_padded=Np)
    assert sc.stoch_shard_supported(fa) == (Np <= SMEM_LIMIT_BYTES)
    assert not sc.stoch_shard_supported(SimpleNamespace(shard_plan=None, n_vars_padded=128))


# ------------------------------------------- tiling in the caller's storage

FIELD_SHAPES = {"1-D": (), "2-D": (5,), "3-D": (3, 7)}
G_FULL = 3  # tiles of a full batch


def _field(B, X, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand((B, *X), generator=g) < 0.5
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, (B, *X), generator=g, dtype=torch.int32)
    return torch.randn((B, *X), generator=g)


def _tile_bytes(x):
    return TILE * int(np.prod(x.shape[1:], dtype=np.int64)) * x.element_size()


@pytest.mark.parametrize("wave", range(1, G_FULL + 1))
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bool], ids=str)
@pytest.mark.parametrize("shape", list(FIELD_SHAPES))
def test_tile_in_place_equals_tile_and_untile_in_place_undoes_it(shape, dtype, wave):
    """A full batch of G_FULL tiles, staging of ``wave`` tiles: the tiles
    are tile's, in the input's own storage, and untile_ gives the input
    back there."""
    x = _field(G_FULL * TILE, FIELD_SHAPES[shape], dtype, seed=wave)
    y = x.clone()
    staging = torch.empty(wave * _tile_bytes(x), dtype=torch.uint8)
    t = tile_(y, staging)
    assert torch.equal(t, tile(x))
    assert t.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()
    u = untile_(t, x.shape[0], staging)
    assert torch.equal(u, x) and u.data_ptr() == y.data_ptr()


@pytest.mark.parametrize("B", [G_FULL * TILE, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bool], ids=str)
@pytest.mark.parametrize("shape", list(FIELD_SHAPES))
def test_tiles_route_full_batches_in_place_and_ragged_ones_through_held_buffers(shape, dtype,
                                                                                 B):
    """Tiles.tile equals tile (padding rows the fill), in place for a full
    batch and in a held buffer for a ragged one; untile writes a chunk's
    result, from the tiles or from any other tensor, into the caller's
    tensor, and a second call of the shape reuses the held buffers."""
    X = FIELD_SHAPES[shape]
    fill = True if dtype == torch.bool else 7
    tiles = Tiles(staging_bytes=1)  # one tile a wave: the least staging
    held = None
    for seed in (1, 2):
        x = _field(B, X, dtype, seed)
        y = x.clone()
        t = tiles.tile({"f": y}, {"f": fill})["f"]
        assert torch.equal(t, tile(x, fill=fill))
        shares = t.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()
        assert shares == (B % TILE == 0)
        if not shares:
            assert held in (None, t.data_ptr())
            held = t.data_ptr()
        result = tile(_field(B, X, dtype, seed + 10), fill=fill)
        out = tiles.untile({"f": result if seed == 1 else t.copy_(result)})["f"]
        assert out is y and torch.equal(out, untile(result, B))


def test_fields_that_cannot_be_tiled_where_they_lie_take_held_buffers():
    """A non-contiguous field and two fields of one storage are copied into
    held buffers and back; the contiguous field beside them is tiled in
    place."""
    base = torch.randn(64, 12)
    shared = torch.randn(64, 8)
    fields = {"cols": base[:, :5], "own": torch.randn(64, 3),
              "a": shared.view(64, 2, 4)[:, 0],  # not contiguous either
              "b": shared.view(-1)[: 64 * 4].view(64, 4)}  # shares a's storage
    assert in_place(fields) == {"cols": False, "a": False, "own": True, "b": False}
    want = {k: tile(v) for k, v in fields.items()}
    tiles = Tiles()
    got = tiles.tile(fields)
    for k, t in got.items():
        assert torch.equal(t, want[k]), k
        same = t.untyped_storage().data_ptr() == fields[k].untyped_storage().data_ptr()
        assert same == (k == "own"), k
    news = {k: t + 1 for k, t in got.items()}
    out = tiles.untile(news)
    for k, x in out.items():
        assert x is fields[k] and torch.equal(x, untile(news[k], 64)), k
    assert torch.equal(base[:, :5], out["cols"])  # written back into the view's storage
