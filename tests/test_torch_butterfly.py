"""B7, the butterfly all-reduce over a clause group
(odesat_tpu_torch/ops/butterfly.py), on the CPU: its plain version on gloo
worlds of S = 2, 3 and 4 ranks, and the clause meshes at S = 4 that run
through it against the JAX package's S = 4 whole-chunk kernels in
interpret mode, whose butterfly is the TPU kernel B7 ports.

* ``butterfly_plain`` equals a NumPy sum in the butterfly's tree order bit
  for bit, on data where rank order and tree order round differently, with
  and without a max zone; every rank gets the same bits.
* The stoch clause mesh at S = 4 (B9's plain version, B7 between its
  launches) equals JAX's S = 4 kernel exactly (v, xl, done): the weight
  sums are integers in f32.
* The ODE clause mesh at S = 4 (B6's plain version) is within the JAX
  test's own rtol 2e-4 / atol 2e-5 (tests/test_shard_chunk.py:160-165) of
  JAX's S = 4 kernel, both integrators; dt rtol 2e-4 / atol 2e-6, done
  exactly.
* The refusals: a CPU tensor into ``butterfly_cuda``, a shape that differs
  between ranks, a group that differs from the plan's shards.

The kernel runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
JAX's runs follow tests/test_shard_chunk.py:200-275 on the forced 8-device
CPU mesh (tests/conftest.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from odesat_tpu.cnf import normalize_cnf_variables  # noqa: E402
from odesat_tpu.models.ode import ODEState as JState  # noqa: E402
from odesat_tpu.models.ode import formula_device  # noqa: E402
from odesat_tpu.ops.shard_chunk import make_shard_chunk_call  # noqa: E402
from odesat_tpu.ops.shard_stream import compile_stream_sharded  # noqa: E402
from odesat_tpu.ops.stoch_pallas import make_stoch_shard_chunk, stoch_shard_arrays  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.generate import random_ksat  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy  # noqa: E402
from odesat_tpu_torch.ops import butterfly as bf  # noqa: E402
from odesat_tpu_torch.parallel import launch, sharded  # noqa: E402
from odesat_tpu_torch.parallel.dist import all_reduce_error, butterfly_of  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from tests.torch_parity import numpy_state  # noqa: E402

ZETA = 0.001
MODES = {"fixed": dict(step_size=0.01), "adaptive": dict(tolerance=1e-3)}


def _tree_sum(parts):
    """NumPy float32 partials (rank order) summed in the butterfly's tree."""
    vals, w = [np.asarray(p, np.float32) for p in parts], 1
    while w < len(vals):
        for i in range(0, len(vals) - w, 2 * w):
            vals[i] = vals[i] + vals[i + w]
        w *= 2
    return vals[0]


def _tree_max(parts):
    vals, w = [np.asarray(p, np.float32) for p in parts], 1
    while w < len(vals):
        for i in range(0, len(vals) - w, 2 * w):
            vals[i] = np.maximum(vals[i], vals[i + w])
        w *= 2
    return vals[0]


def _order_parts(S):
    """Partials on which rank order and tree order differ: (1e8, 1, -1e8,
    1, ...) in the first word, random magnitudes elsewhere."""
    rng = np.random.default_rng(S)
    parts = (rng.uniform(-1, 1, (S, 5, 7)) * 10.0 ** rng.integers(-3, 9, (S, 5, 7)))
    parts = parts.astype(np.float32)
    parts[:, 0, 0] = [(1e8, 1.0, -1e8, 1.0)[k % 4] for k in range(S)]
    return parts


def _calls(S):
    parts = _order_parts(S)
    maxed = parts.copy()
    maxed[:, :, 5:] = np.abs(maxed[:, :, 5:])  # the max zone: the last 2 of every 7 words
    return [(butterfly_of, (list(parts),)), (butterfly_of, (list(maxed), (7, 2))),
            (all_reduce_error, ((3, 33), 5, None, 4)), (all_reduce_error, ((7,), 6, (7, 3), 3))]


def _check_plain(S, values):
    parts = _order_parts(S)
    (out, same), (out_max, same_max), err, err_max = values
    want = _tree_sum(parts)
    assert same and same_max and err == 0.0 and err_max == 0.0
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))
    if S == 4:  # rank order ((a0 + a1) + a2) + a3 gives 1 in the first word, the tree 0
        ring = ((parts[0] + parts[1]) + parts[2]) + parts[3]
        assert ring[0, 0] == 1.0 and out[0, 0] == 0.0
    maxed = parts.copy()
    maxed[:, :, 5:] = np.abs(maxed[:, :, 5:])
    want_max = _tree_sum(maxed)
    want_max[:, 5:] = _tree_max(maxed)[:, 5:]
    np.testing.assert_array_equal(out_max.view(np.int32), want_max.view(np.int32))


@pytest.mark.parametrize("S", [2, 3])
def test_plain_follows_the_tree_order(S):
    values = launch.spawn(launch.run_all, 1, S, "gloo", "cpu", timeout_s=120,
                          args=(_calls(S),))
    _check_plain(S, values)


def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("clause",))


def _jax_ode(jfa, plan, ode, steps, arrays):
    """JAX's whole-chunk ODE kernel at S shards under a clause-only
    shard_map (tests/test_shard_chunk.py's harness)."""
    call = make_shard_chunk_call(jfa, ZETA, ode, steps, interpret=True)
    mesh = _jax_mesh(plan.n_shards)
    dev = formula_device(jfa)

    def local(v, xs, xl, dt, done, planes, lo, bias, cmask):
        return call(v, xs, xl, dt, done, planes[0], lo[0], bias[0], cmask)

    specs = (P(), P(None, "clause"), P(None, "clause"), P(), P(),
             P("clause"), P("clause"), P("clause"), P("clause"))
    fn = shard_map(local, mesh=mesh, in_specs=specs,
                   out_specs=(P(), P(None, "clause"), P(None, "clause"), P(), P()),
                   check_vma=False)
    args = (*(jnp.asarray(a) for a in arrays), dev.planes, dev.span_lo, dev.span_bias,
            dev.clause_mask)
    args = tuple(jax.device_put(a, NamedSharding(mesh, s)) for a, s in zip(args, specs))
    return JState(*(np.asarray(x) for x in jax.jit(fn)(*args)))


def _jax_stoch(jfa, plan, chunk, B, seed):
    """JAX's whole-chunk stoch kernel at S shards from the all-false start
    (tests/test_shard_chunk.py's harness)."""
    call = make_stoch_shard_chunk(jfa, chunk, interpret=True, traj_block=B)
    sbias, nsign = stoch_shard_arrays(jfa)
    mesh = _jax_mesh(plan.n_shards)

    def local(v, xl, done, seed, planes, lo, sbias, nsign, cmask):
        return call(v, xl, done, seed, planes[0], lo[0], sbias[0], nsign[0], cmask)

    specs = (P(), P(None, "clause"), P(), P(), P("clause"), P("clause"), P("clause"),
             P("clause"), P("clause"))
    fn = shard_map(local, mesh=mesh, in_specs=specs, out_specs=(P(), P(None, "clause"), P()),
                   check_vma=False)
    args = (jnp.zeros((B, jfa.n_vars_padded), jnp.float32),
            jnp.ones((B, jfa.n_clauses_padded), jnp.float32), jnp.zeros((B,), jnp.bool_),
            jnp.asarray([seed], jnp.int32), jnp.asarray(plan.planes), jnp.asarray(plan.lo),
            jnp.asarray(sbias), jnp.asarray(nsign), jnp.asarray(jfa.clause_mask))
    args = tuple(jax.device_put(a, NamedSharding(mesh, s)) for a, s in zip(args, specs))
    v, xl, done = jax.jit(fn)(*args)
    return np.asarray(v) > 0.5, np.asarray(xl).astype(np.int32), np.asarray(done)


def _s4_case(seed):
    formula = random_ksat(96, 420, k=3, seed=seed, planted=True)
    return compile_stream_sharded(normalize_cnf_variables(formula)[1], 4)


def test_s4_meshes_equal_jax_butterfly_kernels():
    """One world of four gloo ranks: B7's plain version in the tree order,
    then the ODE clause mesh (both integrators) and the stoch clause mesh
    at S = 4 against JAX's S = 4 kernels in interpret mode."""
    jfa, plan = _s4_case(5)
    arrays = numpy_state(jfa, 8, 4)
    arrays[4][3] = True  # a row that must not move
    steps = 6
    tfa = formula_arrays_from_numpy(jfa)
    ode_cases = [(tfa, ZETA, ODEConfig(**MODES[m]), steps, arrays) for m in MODES]
    sfa, splan = _s4_case(7)
    B, chunk = 8, 12
    calls = _calls(4) + [(sharded.run_ode_cases, (ode_cases,)),
                         (sharded.run_stoch_clause,
                          (formula_arrays_from_numpy(sfa), 1, chunk, 3, "float32", B, "auto"))]
    values = launch.spawn(launch.run_all, 1, 4, "gloo", "cpu", timeout_s=240, args=(calls,))
    _check_plain(4, values[:4])
    for (mode, kw), out in zip(MODES.items(), values[4]):
        ref = _jax_ode(jfa, plan, JODE(**kw), steps, arrays)
        for name, a, b in zip(("v", "xs", "xl"), out[:3], ref[:3]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=f"{mode} {name}")
        np.testing.assert_allclose(out[3], ref.dt, rtol=2e-4, atol=2e-6, err_msg=mode)
        np.testing.assert_array_equal(out[4], ref.done, err_msg=mode)
        np.testing.assert_array_equal(out[0][3], arrays[0][3])
        assert all(np.array_equal(c, out[5][0]) for c in out[5])  # v on every clause rank
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=sharded.row_generator(3, None)))
    jv, jxl, jdone = _jax_stoch(sfa, splan, chunk, B, seed)
    v, xl, done = values[5]
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(xl, jxl)
    np.testing.assert_array_equal(done, jdone)
    assert v.any()  # flips happened


def test_butterfly_cuda_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensors"):
        bf.butterfly_cuda(torch.zeros(7), None)


def test_a_shape_that_differs_between_ranks_is_refused():
    parts = [np.zeros(7, np.float32), np.zeros(8, np.float32)]
    with pytest.raises(ValueError, match="shapes"):
        launch.spawn(butterfly_of, 1, 2, "gloo", "cpu", timeout_s=120, args=(parts,))


@pytest.mark.parametrize("engine", ["ode", "stoch"])
def test_a_group_that_differs_from_the_plan_is_refused(engine):
    jfa, _ = _s4_case(5)
    tfa = formula_arrays_from_numpy(jfa)
    if engine == "ode":
        fn, args = sharded.run_ode_cases, ([(tfa, ZETA, ODEConfig(step_size=0.01), 2,
                                             numpy_state(jfa, 4, 1))],)
    else:
        fn, args = sharded.run_stoch_clause, (tfa, 1, 2, 3, "float32", 4, "auto")
    with pytest.raises(ValueError, match="4 shards but the (mesh|clause group) 2"):
        launch.spawn(fn, 1, 2, "gloo", "cpu", timeout_s=120, args=args)


def test_zones_and_the_plain_tree():
    """The plain tree and zones in one process: the max zone's NaN and
    signed zeros, and a bad zone refused."""
    a = torch.tensor([1.0, -0.0, float("nan"), 2.0])
    b = torch.tensor([2.0, 0.0, 1.0, -3.0])
    c = torch.tensor([4.0, 0.0, 0.0, 8.0])
    out = bf.combine([a, b, c], (4, 3))  # the last three words take the max
    assert out[0].item() == 7.0  # (1 + 2) + 4
    assert str(out[1].item()) == "-0.0"  # of equal values the lower rank's
    assert torch.isnan(out[2]) and out[3].item() == 8.0
    with pytest.raises(ValueError, match="zones"):
        bf.zone_args((4, 5), 8)
