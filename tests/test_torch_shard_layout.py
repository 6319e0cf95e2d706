"""The tile layout of the clause-mesh chunks B6 and B9 on the CPU
(odesat_tpu_torch/ops/tiles.py): the interleave helpers, and the chunk
runners, which tile their rows on every device, at ragged batch sizes.

* ``tile``/``untile`` round-trip every buffer dtype the chunks tile (f32
  state and staging, bool done and stoch v, int32 stoch xl) for B in {1,
  7, 8, 33, 64}, always as copies, place row ``g*R + r`` at tile ``g``,
  lane ``r``, and pad the last tile with the fill.
* The runners at ragged B (7, 16 or 33 rows: a part-filled last tile of
  32) against the JAX package's whole-chunk kernels in interpret mode, at
  the tolerances of tests/test_torch_shard_chunk.py (ODE v, xs, xl rtol
  2e-4 / atol 2e-5, dt rtol 2e-4 / atol 2e-6, done exactly; stoch
  exactly), and against the per-step paths B5 and B8 bit for bit.
* The tiled plain launch equals the plain launch row for row, padding
  rows never reaching a real row.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from odesat_tpu.cnf import normalize_cnf_variables  # noqa: E402
from odesat_tpu.models import ode as jode  # noqa: E402
from odesat_tpu.ops import stoch_pallas as jsp  # noqa: E402
from odesat_tpu.ops.shard_chunk import make_shard_chunk_call  # noqa: E402
from odesat_tpu.ops.shard_stream import compile_stream_sharded as jcompile_sharded  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.generate import random_ksat  # noqa: E402
from odesat_tpu_torch.cnf import CNFFormula, Literal  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy, state_from_numpy  # noqa: E402
from odesat_tpu_torch.models.loop import copy_state  # noqa: E402
from odesat_tpu_torch.models.stoch import StochState  # noqa: E402
from odesat_tpu_torch.ops import shard_chunk as sch  # noqa: E402
from odesat_tpu_torch.ops import shard_stream as ss  # noqa: E402
from odesat_tpu_torch.ops import stoch_chunk as sc  # noqa: E402
from odesat_tpu_torch.ops.tiles import TILE, n_tiles, rows_of, tile, untile  # noqa: E402
from odesat_tpu_torch.parallel import sharded  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from tests.torch_parity import jax_state, numpy_state  # noqa: E402

ZETA = 0.001
MODES = {"fixed": dict(step_size=0.01), "adaptive": dict(tolerance=1e-3)}
DTYPES = {"float32": torch.float32, "bool": torch.bool, "int32": torch.int32}


def _random(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == torch.bool:
        return torch.as_tensor(rng.random(shape) < 0.5)
    if dtype == torch.int32:
        return torch.as_tensor(rng.integers(-3000, 3001, shape).astype(np.int32))
    return torch.as_tensor(rng.uniform(-2, 2, shape).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B", [1, 7, 8, 33, 64])
@pytest.mark.parametrize("width", [None, 1, 129])
def test_tile_round_trip(B, dtype, width):
    x = _random((B,) if width is None else (B, width), DTYPES[dtype], seed=B)
    t = tile(x)
    G = n_tiles(B)
    assert t.shape == (G, *x.shape[1:], TILE) and t.dtype == x.dtype and t.is_contiguous()
    assert rows_of(t) == G * TILE
    back = untile(t, B)
    assert torch.equal(back, x)
    # copies both ways, also where a reshape alone would do (B = 64, 1-D):
    # the kernels write the tiles in place and the caller's state stays
    for a, b in ((t, x), (back, t)):
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    for b in range(B):  # row g*R + r at tile g, lane r
        assert torch.equal(t[b // TILE, ..., b % TILE], x[b])


@pytest.mark.parametrize("R", [8, TILE])
def test_tile_pads_the_last_tile(R):
    x = torch.arange(10 * 3, dtype=torch.float32).reshape(10, 3)
    t = tile(x, R, fill=-5.0)
    pad = untile(t, rows_of(t))[10:]
    assert pad.shape == (rows_of(t) - 10, 3) and (pad == -5.0).all()
    done = tile(torch.zeros(10, dtype=torch.bool), R, fill=True)
    assert untile(done, rows_of(done))[10:].all() and not untile(done, 10).any()


def _formula(seed=5):
    return normalize_cnf_variables(random_ksat(96, 420, k=3, seed=seed, planted=True))[1]


def _port(formula):
    return CNFFormula([tuple(Literal(lit.variable, lit.is_negated) for lit in c)
                       for c in formula.clauses], formula.varnum)


@pytest.mark.parametrize("B", [7, 33])
@pytest.mark.parametrize("mode", list(MODES))
def test_tiled_runner_matches_jax_shard_chunk(mode, B):
    jfa, _ = jcompile_sharded(_formula(), 1)
    arrays = numpy_state(jfa, B, 4)
    arrays[4][3] = True  # a row that must not move
    steps = 5
    ode = dict(rigidity="reference", **MODES[mode])
    call = make_shard_chunk_call(jfa, ZETA, JODE(**ode), steps, interpret=True)
    dev = jode.formula_device(jfa)
    ref = call(*jax_state(arrays), dev.planes[0], dev.span_lo[0], dev.span_bias[0],
               dev.clause_mask)
    run = sch.make_shard_chunk(formula_arrays_from_numpy(jfa), ZETA, ODEConfig(**ode), steps,
                               None, "cpu")
    # copies: the runner consumes its input, which would otherwise be arrays'
    out = run(state_from_numpy(*(a.copy() for a in arrays), device="cpu"))
    for name, a, b in zip(("v", "xs", "xl"), out[:3], ref[:3]):
        assert a.shape == (B, *b.shape[1:])
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(out.done.numpy(), np.asarray(ref[4]))
    np.testing.assert_allclose(out.dt.numpy(), np.asarray(ref[3]), rtol=2e-4, atol=2e-6)
    np.testing.assert_array_equal(out.v.numpy()[3], arrays[0][3])


@pytest.mark.parametrize("B", [7, 16])
def test_tiled_stoch_runner_matches_jax_shard_chunk(B):
    """B < 32 chains: one ragged tile. The counter hash's chain blocking
    (``traj_block``) is the JAX kernel's at these B."""
    jfa, jplan = jcompile_sharded(_formula(seed=7), 1)
    tfa = formula_arrays_from_numpy(jfa)
    chunk, seed = 6, 99
    rng = np.random.default_rng(B)
    v = rng.random((B, jfa.n_vars_padded)) < 0.5
    xl = rng.integers(1, 3001, (B, jfa.n_clauses_padded)).astype(np.int32)
    done = np.zeros(B, bool)
    done[2] = True
    call = jsp.make_stoch_shard_chunk(jfa, chunk, interpret=True, traj_block=sc.traj_block(B))
    sbias, nsign = jsp.stoch_shard_arrays(jfa)
    jv, jxl, jdone = call(jnp.asarray(v, jnp.float32), jnp.asarray(xl, jnp.float32),
                          jnp.asarray(done), jnp.asarray([seed], jnp.int32),
                          jnp.asarray(jplan.planes[0]), jnp.asarray(jplan.lo[0]),
                          jnp.asarray(sbias[0]), jnp.asarray(nsign[0]),
                          jnp.asarray(jfa.clause_mask))
    fn = sc.make_stoch_shard_chunk(tfa, chunk, "cpu")
    out = fn(StochState(torch.tensor(v), torch.tensor(xl), torch.tensor(done)), seed)
    np.testing.assert_array_equal(out.v.numpy(), np.asarray(jv) > 0.5)
    np.testing.assert_array_equal(out.xl.numpy(), np.asarray(jxl).astype(np.int32))
    np.testing.assert_array_equal(out.done.numpy(), np.asarray(jdone))
    assert (out.v.numpy() != v).any()


@pytest.mark.parametrize("B", [1, 7, 33])
@pytest.mark.parametrize("mode", list(MODES))
def test_tiled_runner_equals_the_step_path(mode, B):
    """B6's schedule on tiled rows computes what B5's per-step path
    computes on the rows as they are, bit for bit."""
    fa, _ = ss.compile_stream_sharded(_port(_formula(seed=8)), 1)
    ode = ODEConfig(**MODES[mode])
    v, xs, xl, dt, done = numpy_state(fa, B, 1)
    done[::3] = True
    state = state_from_numpy(v, xs, xl, dt, done, device="cpu")
    a = sch.make_shard_chunk(fa, 0.05, ode, 12, None, "cpu")(copy_state(state))
    b = ss.make_single_device_runner(fa, 0.05, ode, 12, "cpu")(state)
    for name, x, y in zip(state._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("B", [7, 33])
def test_tiled_stoch_runner_equals_the_eval_path(B):
    fa, _ = ss.compile_stream_sharded(_port(_formula(seed=9)), 1)
    a = sharded.run_stoch_clause(None, "cpu", fa, 2, 7, 3, "float32", B, "auto")
    b = sharded.run_stoch_clause(None, "cpu", fa, 2, 7, 3, "float32", B, "off")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("phase,apply", [("step", True), ("first", True), ("half", False),
                                         ("commit", False)])
def test_tiled_plain_launch_is_row_for_row(phase, apply):
    """One launch on tiled buffers whose padding rows hold other values
    equals the plain launch on the real rows."""
    fa, _ = ss.compile_stream_sharded(_port(_formula(seed=3)), 1)
    fixed = phase == "step"
    spec = ss.shard_spec(fa, ZETA, ODEConfig(**MODES["fixed" if fixed else "adaptive"]), "cpu")
    B, rng = 9, np.random.default_rng(6)
    Np, Mp = fa.n_vars_padded, fa.n_clauses_padded

    def put(*shape, lo=-1.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32))

    acc = put(B, Np + 1)
    acc[:, Np] = torch.as_tensor(rng.integers(0, 2, B).astype(np.float32))
    b = sch.ChunkBuffers(put(B, Np), put(B, Mp, lo=0.01, hi=0.99), put(B, Mp, lo=1, hi=9),
                         put(B, lo=0.01, hi=0.05), torch.as_tensor(rng.random(B) < 0.3), acc)
    if not fixed:  # acc2 = (dv2 | the step-doubling error)
        acc2 = put(B, Np + 1)
        acc2[:, Np] = put(B, lo=0, hi=1e-2)
        b = b._replace(acc2=acc2, dxs1=put(B, Mp), dxl1=put(B, Mp))
    ref = sch.shard_chunk_plain(phase, b, spec, apply)
    tiled = sch.ChunkBuffers(*(None if t is None else tile(t, fill=7) for t in b))
    out = sch.shard_chunk_phase(phase, tiled, spec, apply)
    for name, x, y in zip(b._fields, out, ref):
        assert (x is None and y is None) or torch.equal(untile(x, B), y), name
