"""B7, the butterfly all-reduce over a clause group
(odesat_tpu_torch/ops/butterfly.py), on the CPU: its plain version on gloo
worlds of S = 2, 3 and 4 ranks, and the clause meshes at S = 4 that run
through it against the JAX package's S = 4 whole-chunk kernels in
interpret mode, whose butterfly is the TPU kernel B7 ports.

* ``butterfly_plain`` equals a NumPy sum in the butterfly's tree order bit
  for bit, on data where rank order and tree order round differently, with
  and without a max zone; every rank gets the same bits. Float32 at S = 2,
  3 and 4, and the float64 form (the torch twin's clause step) at S = 2, 3
  and 4 with NaN, signed zeros and infinities of both signs (the unit
  clauses' gradients) in both zones; a NaN equals any NaN.
* The stoch clause mesh at S = 4 (B9's plain version, fed the gathered
  partials, which it sums in B7's tree) equals JAX's S = 4 kernel exactly
  (v, xl, done): the weight sums are integers in f32.
* The ODE clause mesh at S = 4 (B6's plain version) is within the JAX
  test's own rtol 2e-4 / atol 2e-5 (tests/test_shard_chunk.py:160-165) of
  JAX's S = 4 kernel, both integrators; dt rtol 2e-4 / atol 2e-6, done
  exactly.
* The refusals: a CPU tensor into ``butterfly_cuda``, a shape or a dtype
  that differs between ranks, a dtype with no form, a group that differs
  from the plan's shards.

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


def _tree(parts, op):
    """NumPy partials (rank order) combined by ``op`` in the butterfly's
    tree."""
    vals, w = [np.asarray(p) for p in parts], 1
    with np.errstate(invalid="ignore"):  # inf - inf: NaN, as B7 gives
        while w < len(vals):
            for i in range(0, len(vals) - w, 2 * w):
                vals[i] = op(vals[i], vals[i + w])
            w *= 2
    return vals[0]


def _tree_sum(parts):
    return _tree(parts, np.add)


def _b7_max(a, b):
    """B7's max: NaN if either is NaN, else the larger, the lower rank's
    of two equal values (of +0 and -0)."""
    return np.where(np.isnan(a) | np.isnan(b), np.nan, np.where(a < b, b, a)).astype(a.dtype)


def _tree_max(parts):
    return _tree(parts, _b7_max)


# float32: the first word (1e8, 1, -1e8, 1, ...) rounds differently in rank
# order and in the tree; float64 needs 1e17 for that
BIG = {np.float32: (1e8, 9), np.float64: (1e17, 18)}


def _order_parts(S, dtype=np.float32):
    """Partials on which rank order and tree order differ: (big, 1, -big,
    1, ...) in the first word, random magnitudes elsewhere. float64 also
    holds NaN, signed zeros and infinities of both signs in both zones."""
    big, top = BIG[dtype]
    rng = np.random.default_rng(S)
    parts = (rng.uniform(-1, 1, (S, 5, 7)) * 10.0 ** rng.integers(-3, top, (S, 5, 7)))
    parts = parts.astype(dtype)
    parts[:, 0, 0] = [(big, 1.0, -big, 1.0)[k % 4] for k in range(S)]
    if dtype == np.float64:
        for word in ((1, 1), (2, 6)):  # a sum-zone word, a max-zone word
            parts[:, word[0], word[1]] = [(np.inf, -np.inf, 1.0, 2.0)[k % 4] for k in range(S)]
        parts[1, 3, 2] = parts[-1, 3, 6] = np.nan
        parts[:, 4, 3] = parts[:, 4, 5] = [(-0.0, 0.0, 0.0, -0.0)[k % 4] for k in range(S)]
        parts[:, 4, 6] = [(0.0, -0.0, -0.0, 0.0)[k % 4] for k in range(S)]
        parts[:, 3, 5] = [(np.inf, 5.0, -np.inf, 7.0)[k % 4] for k in range(S)]
    return parts


def _maxed(parts):
    maxed = parts.copy()
    maxed[:, :, 5:] = np.abs(maxed[:, :, 5:])  # the max zone: the last 2 of every 7 words
    if parts.dtype == np.float64:  # keep the signed zeros and -inf of the max zone
        maxed[:, 4, 5:], maxed[:, 3, 5], maxed[:, 2, 6] = (parts[:, 4, 5:], parts[:, 3, 5],
                                                           parts[:, 2, 6])
    return maxed


def _calls(S, dtype=np.float32):
    parts = _order_parts(S, dtype)
    maxed = _maxed(parts)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    return [(butterfly_of, (list(parts), None, dtype)),
            (butterfly_of, (list(maxed), (7, 2), dtype)),
            (all_reduce_error, ((3, 33), 5, None, 4, tdtype)),
            (all_reduce_error, ((7,), 6, (7, 3), 3, tdtype))]


def _same_bits(a, b):
    """Bit for bit, a NaN equal to any NaN."""
    assert a.dtype == b.dtype
    ints = np.int64 if a.dtype == np.float64 else np.int32
    return bool(np.all((a.view(ints) == b.view(ints)) | (np.isnan(a) & np.isnan(b))))


def _check_plain(S, values, dtype=np.float32):
    parts = _order_parts(S, dtype)
    (out, same), (out_max, same_max), err, err_max = values
    want = _tree_sum(parts)
    assert same and same_max and err == 0.0 and err_max == 0.0
    assert out.dtype == dtype and _same_bits(out, want)
    if S == 4:  # rank order ((a0 + a1) + a2) + a3 gives 1 in the first word, the tree 0
        with np.errstate(invalid="ignore"):
            ring = ((parts[0] + parts[1]) + parts[2]) + parts[3]
        assert ring[0, 0] == 1.0 and out[0, 0] == 0.0
    maxed = _maxed(parts)
    want_max = _tree_sum(maxed)
    want_max[:, 5:] = _tree_max(maxed)[:, 5:]
    assert _same_bits(out_max, want_max)
    if dtype == np.float64:
        assert np.isnan(out[1, 1]) and np.isnan(out[3, 2])  # inf - inf; a NaN partial
        assert out_max[2, 6] == np.inf and out_max[3, 5] == np.inf and np.isnan(out_max[3, 6])
        assert np.signbit(out_max[4, 5]) and not np.signbit(out_max[4, 6])  # rank 0's zero


@pytest.mark.parametrize("S,dtype", [
    pytest.param(2, np.float32, id="2"), pytest.param(3, np.float32, id="3"),
    pytest.param(2, np.float64, id="f64-2"), pytest.param(3, np.float64, id="f64-3"),
    pytest.param(4, np.float64, id="f64-4"),
])
def test_plain_follows_the_tree_order(S, dtype):
    values = launch.spawn(launch.run_all, 1, S, "gloo", "cpu", timeout_s=120,
                          args=(_calls(S, dtype),))
    _check_plain(S, values, dtype)


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


def test_a_dtype_that_differs_between_ranks_is_refused():
    """Rank 0 passes float32, rank 1 float64 (each its own part's dtype):
    every rank raises."""
    parts = [np.zeros(7, np.float32), np.zeros(7, np.float64)]
    with pytest.raises(ValueError, match="dtypes"):
        launch.spawn(butterfly_of, 1, 2, "gloo", "cpu", timeout_s=120, args=(parts, None, None))


def test_a_dtype_without_a_form_is_refused():
    with pytest.raises(ValueError, match="float32 or float64"):
        bf.butterfly_plain(torch.zeros(7, dtype=torch.float16), None)
    with pytest.raises(ValueError, match="float32 or float64"):
        bf.check_dtype(torch.bfloat16)


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
    # the float64 form: the same rules, the canonical NaN of the max
    a, b, c = (x.double() for x in (a, b, c))
    out = bf.combine([a, b, c], (4, 3))
    assert out.dtype == torch.float64 and out[0].item() == 7.0
    assert str(out[1].item()) == "-0.0" and torch.isnan(out[2]) and out[3].item() == 8.0
