"""The clause-sharded chunks on the CPU: kernels B6 (ODE,
odesat_tpu_torch/ops/shard_chunk.py) and B9 (stoch, ops/stoch_chunk.py)
through their plain versions.

* Against the JAX package's whole-chunk Pallas kernels
  (``make_shard_chunk_call``, ``make_stoch_shard_chunk``) in interpret mode
  at S=1, where their in-kernel butterfly has no partner: the ODE chunk to
  rtol 2e-4 / atol 2e-5 on v, xs, xl (the JAX test's own,
  tests/test_shard_chunk.py:91-98), dt to rtol 2e-4 / atol 2e-6, done
  exactly; the stoch chunk exactly (integer weights in f32, the same
  counter hash).
* Against the per-step paths they replace (B5, B8): bit for bit.
* The ``shard_chunk`` choice, the CLI flag, and the stoch engine's own
  gate for the clause-sharded layout.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py); the clause mesh at S=2 is in tests/test_torch_sharding.py
and tests/test_torch_stoch_shard.py.
"""

import contextlib
import io
import os
from types import SimpleNamespace

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
from odesat_tpu_torch import cli  # noqa: E402
from odesat_tpu_torch.cnf import CNFFormula, Literal  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy, state_from_numpy  # noqa: E402
from odesat_tpu_torch.models.stoch import StochState  # noqa: E402
from odesat_tpu_torch.ops import shard_chunk as sch  # noqa: E402
from odesat_tpu_torch.ops import shard_stream as ss  # noqa: E402
from odesat_tpu_torch.ops import stoch_chunk as sc  # noqa: E402
from odesat_tpu_torch.parallel import sharded  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
from tests.torch_parity import jax_state, numpy_state  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZETA = 0.001
MODES = {"fixed": dict(step_size=0.01), "adaptive": dict(tolerance=1e-3)}


def _formula(seed=5):
    return normalize_cnf_variables(random_ksat(96, 420, k=3, seed=seed, planted=True))[1]


def _arrays(fa, B=8, seed=4):
    v, xs, xl, dt, done = numpy_state(fa, B, seed)
    done[3] = True  # a row that must not move
    return v, xs, xl, dt, done


@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("mode", list(MODES))
def test_chunk_plain_matches_jax_shard_chunk(mode, rigidity):
    jfa, _ = jcompile_sharded(_formula(), 1)
    arrays = _arrays(jfa)
    steps = 7  # odd: the JAX kernel's parity flush runs too
    call = make_shard_chunk_call(jfa, ZETA, JODE(rigidity=rigidity, **MODES[mode]), steps,
                                 interpret=True)
    dev = jode.formula_device(jfa)
    ref = call(*jax_state(arrays), dev.planes[0], dev.span_lo[0], dev.span_bias[0],
               dev.clause_mask)
    run = sch.make_shard_chunk(formula_arrays_from_numpy(jfa), ZETA,
                               ODEConfig(rigidity=rigidity, **MODES[mode]), steps, None, "cpu")
    out = run(state_from_numpy(*arrays, device="cpu"))
    for name, a, b in zip(("v", "xs", "xl"), out[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(out.done.numpy(), np.asarray(ref[4]))
    np.testing.assert_allclose(out.dt.numpy(), np.asarray(ref[3]), rtol=2e-4, atol=2e-6)
    np.testing.assert_array_equal(out.v.numpy()[3], arrays[0][3])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_chunk_equals_the_step_path_bit_for_bit(mode, matmul_dtype):
    """B6's schedule computes what B5's per-step path computes, through a
    chunk in which rows finish (uf-like planted formula, long chunk)."""
    fa, _ = ss.compile_stream_sharded(_port(_formula(seed=8)), 1)
    ode = ODEConfig(matmul_dtype=matmul_dtype, **MODES[mode])
    state = state_from_numpy(*_arrays(fa, B=6, seed=1), device="cpu")
    a = sch.make_shard_chunk(fa, 0.05, ode, 40, None, "cpu")(state)
    b = ss.make_single_device_runner(fa, 0.05, ode, 40, "cpu")(state)
    for name, x, y in zip(state._fields, a, b):
        assert torch.equal(x, y), name


def _port(formula):
    return CNFFormula([tuple(Literal(lit.variable, lit.is_negated) for lit in c)
                       for c in formula.clauses], formula.varnum)


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_stoch_chunk_plain_equals_jax_shard_chunk(matmul_dtype):
    jfa, jplan = jcompile_sharded(_formula(seed=7), 1)
    tfa = formula_arrays_from_numpy(jfa)
    B, chunk, seed = 8, 11, 4242
    rng = np.random.default_rng(2)
    v = rng.random((B, jfa.n_vars_padded)) < 0.5
    xl = rng.integers(1, 3001, (B, jfa.n_clauses_padded)).astype(np.int32)
    done = np.zeros(B, bool)
    done[5] = True
    call = jsp.make_stoch_shard_chunk(jfa, chunk, interpret=True, traj_block=B,
                                      matmul_dtype=matmul_dtype)
    sbias, nsign = jsp.stoch_shard_arrays(jfa)
    jv, jxl, jdone = call(jnp.asarray(v, jnp.float32), jnp.asarray(xl, jnp.float32),
                          jnp.asarray(done), jnp.asarray([seed], jnp.int32),
                          jnp.asarray(jplan.planes[0]), jnp.asarray(jplan.lo[0]),
                          jnp.asarray(sbias[0]), jnp.asarray(nsign[0]),
                          jnp.asarray(jfa.clause_mask))
    fn = sc.make_stoch_shard_chunk(tfa, chunk, "cpu", matmul_dtype=matmul_dtype)
    out = fn(StochState(torch.as_tensor(v), torch.as_tensor(xl), torch.as_tensor(done)), seed)
    np.testing.assert_array_equal(out.v.numpy(), np.asarray(jv) > 0.5)
    np.testing.assert_array_equal(out.xl.numpy(), np.asarray(jxl).astype(np.int32))
    np.testing.assert_array_equal(out.done.numpy(), np.asarray(jdone))
    assert (out.v.numpy() != v).any()  # flips happened


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_stoch_chunk_equals_the_eval_path(matmul_dtype):
    """B9's schedule flips exactly as B8's path with the flips in torch."""
    fa, _ = ss.compile_stream_sharded(_port(_formula(seed=9)), 1)
    a = sharded.run_stoch_clause(None, "cpu", fa, 3, 9, 5, matmul_dtype, 8, "auto")
    b = sharded.run_stoch_clause(None, "cpu", fa, 3, 9, 5, matmul_dtype, 8, "off")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_resolve_shard_chunk():
    cases = {("auto", True): True, ("auto", False): False, ("on", False): True,
             ("off", True): False, (True, False): True, (False, True): False}
    for (value, eligible), want in cases.items():
        assert sch.resolve_shard_chunk(value, eligible) is want
    with pytest.raises(ValueError, match="'auto', 'on' or 'off'"):
        sch.resolve_shard_chunk("sometimes", True)


def test_chunk_refusals():
    fa, _ = ss.compile_stream_sharded(_port(_formula()), 1)
    with pytest.raises(ValueError, match="per-trajectory dt"):
        sch.make_shard_chunk(fa, ZETA, ODEConfig(step_size=0.01, dt_mode="shared"), 4, None, "cpu")
    meta = SimpleNamespace(v=torch.empty((2, fa.n_vars_padded), device="meta"))
    with pytest.raises(ValueError, match="no shard chunk path"):
        sch.shard_chunk_phase("step", meta, None)
    spec = ss.shard_spec(fa, ZETA, ODEConfig(step_size=0.01), "cpu")
    b = sch.ChunkBuffers(*(torch.zeros(1) for _ in range(6)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sch.shard_chunk_cuda("step", b, spec)


def test_stoch_compile_for_mesh_takes_unit_clauses():
    """The stoch engine lays a clause mesh out for its own kernels (B8 and
    B9 take unit clauses); the ODE engine keeps B5's gate."""
    f = CNFFormula([(Literal(0, False),), (Literal(0, True), Literal(1, False)),
                    (Literal(1, True), Literal(2, False), Literal(0, False))], 3)
    mesh = SimpleNamespace(n_clause=2)
    config = SolverConfig()
    assert sharded.compile_for_mesh(f, config, mesh, engine="stoch").shard_plan is not None
    assert sharded.compile_for_mesh(f, config, mesh).shard_plan is None


def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    return rc, out.getvalue()


def test_cli_shard_chunk_needs_a_clause_mesh(capsys):
    easy = os.path.join(REPO, "tests", "data", "easy.cnf")
    with pytest.raises(SystemExit) as e:
        _cli("inter", "-f", easy, "-b", "8", "-n", "10", "--device", "cpu", "--shard-chunk")
    assert e.value.code == 2
    assert "--clause-shards" in capsys.readouterr().err


@pytest.mark.parametrize("cmd,extra", [
    ("inter", ("-b", "8", "-s", "0.01", "-n", "2000")),
    ("stoch", ("-b", "8", "-n", "2000")),
])
def test_cli_shard_chunk_off_runs_the_step_path(cmd, extra):
    easy = os.path.join(REPO, "tests", "data", "easy.cnf")
    rc, text = _cli(cmd, "-f", easy, "--seed", "1", *extra, "--device", "cpu",
                    "--clause-shards", "2", "--dist-backend", "gloo", "--shard-chunk", "off")
    assert rc == 0
    assert "Checking if solution vector satisfies formula: true" in text
