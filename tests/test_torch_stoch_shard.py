"""The stochastic engine's clause mesh on the CPU: kernel B8's plain
version (odesat_tpu_torch/ops/stoch_chunk.py ``stoch_shard_eval_plain``)
against the JAX package's Pallas kernel ``make_stoch_shard_eval`` in
interpret mode, and the clause path end to end on a gloo world.

Tolerances: none. The weights are integers in f32, so the partial sums,
the new weights and the sat flags agree exactly, in f32 and with bf16
rounding of each weight; and the clause path at S=2 flips exactly as at
S=1 (the same counter-hash uniforms on both ranks of a row).

B8 itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from odesat_tpu.cnf import normalize_cnf_variables  # noqa: E402
from odesat_tpu.ops import shard_stream as jss  # noqa: E402
from odesat_tpu.ops import stoch_pallas as jsp  # noqa: E402
from odesat_tpu.utils.generate import random_ksat  # noqa: E402
from odesat_tpu_torch.cnf import CNFFormula, Literal  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy  # noqa: E402
from odesat_tpu_torch.models.stoch import make_stoch_clause_eval  # noqa: E402
from odesat_tpu_torch.ops import shard_stream as tss  # noqa: E402
from odesat_tpu_torch.ops import stoch_chunk as sc  # noqa: E402
from odesat_tpu_torch.parallel import sharded  # noqa: E402
from odesat_tpu_torch.parallel.launch import spawn  # noqa: E402
from tests.torch_parity import port_formula  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mixed(seed=3):
    """Widths 2 to 5 in several buckets, 60 variables."""
    clauses = []
    for k, m in ((2, 60), (3, 200), (5, 60)):
        clauses += random_ksat(60, m, k=k, seed=seed + k).clauses
    from odesat_tpu.cnf.formula import CNFFormula as JCNF

    return normalize_cnf_variables(JCNF(clauses, 60))[1]


def _chains(fa, B, seed):
    rng = np.random.default_rng(seed)
    v = rng.random((B, fa.n_vars_padded)) < 0.5
    xl = rng.integers(1, 3001, (B, fa.n_clauses_padded)).astype(np.int32)
    active = rng.random(B) < 0.75
    return v, xl, active


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_eval_plain_equals_pallas(n_shards, mm):
    jfa, jplan = jss.compile_stream_sharded(_mixed(), n_shards)
    tfa = formula_arrays_from_numpy(jfa)
    ev = jsp.make_stoch_shard_eval(jfa, interpret=True, matmul_dtype=mm)
    sbias, nsign = jsp.stoch_shard_arrays(jfa)
    B = 8
    v, xl, active = _chains(jfa, B, seed=n_shards)
    ml = jplan.mp_local
    for s in range(n_shards):
        seg = slice(s * ml, (s + 1) * ml)
        jt, ju, jx, js = ev(jnp.asarray(v, jnp.float32), jnp.asarray(xl[:, seg], jnp.float32),
                            jnp.asarray(active), jnp.asarray(jplan.planes[s]),
                            jnp.asarray(jplan.lo[s]), jnp.asarray(sbias[s]),
                            jnp.asarray(nsign[s]), jnp.asarray(jfa.clause_mask[seg]))
        tev = sc.make_stoch_shard_eval(tfa, "cpu", s, mm)
        tt, tu, tx, ts = tev(torch.as_tensor(v), torch.as_tensor(np.ascontiguousarray(xl[:, seg])),
                             torch.as_tensor(active))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx).astype(np.int32))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_eval_plain_equals_twin_clause_eval(n_shards):
    """B8's plain version and the twin's clause evaluation give the same
    integers (the twin over the same segments)."""
    tfa, _ = tss.compile_stream_sharded(port_formula(_mixed(seed=9)), n_shards)
    v, xl, active = _chains(tfa, 5, seed=7)
    ml = tfa.n_clauses_padded // n_shards
    for s in range(n_shards):
        seg = slice(s * ml, (s + 1) * ml)
        args = (torch.as_tensor(v), torch.as_tensor(np.ascontiguousarray(xl[:, seg])),
                torch.as_tensor(active))
        a = sc.make_stoch_shard_eval(tfa, "cpu", s)(*args)
        b = make_stoch_clause_eval(tfa, "cpu", s, n_shards)(*args)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_eval_takes_unit_clauses_and_refuses_other_devices():
    f = CNFFormula([(Literal(0, False),), (Literal(0, True), Literal(1, False))], 2)
    fa, _ = tss.compile_stream_sharded(f, 2)
    ev = sc.make_stoch_shard_eval(fa, "cpu", 0)
    v = torch.zeros((3, fa.n_vars_padded), dtype=torch.bool)
    xl = torch.ones((3, fa.n_clauses_padded // 2), dtype=torch.int32)
    total, unsat, xl_new, sat = ev(v, xl, torch.ones(3, dtype=torch.bool))
    assert not sat.any()  # the unit clause (x0) is false with v all false
    meta = torch.empty((3, fa.n_vars_padded), device="meta")
    with pytest.raises(ValueError, match="no stoch shard path"):
        ev(meta, xl, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sc.stoch_shard_eval_cuda(v, xl, torch.ones(3, dtype=torch.bool), ev.spec, False)


@pytest.fixture(scope="module", params=["auto", "off"])
def s2_vs_s1(request):
    """The clause path on easy.cnf-sized random 3-SAT: 6 chunks of 8 steps
    at S=2 (two gloo ranks) and at S=1 in this process, through B9's plain
    version (``shard_chunk='auto'``) and through B8's ('off')."""
    from odesat_tpu_torch.cnf import normalize_cnf_variables as tnorm
    from odesat_tpu_torch.utils.generate import random_ksat as trandom

    formula = tnorm(trandom(100, 420, seed=5, planted=True))[1]
    fa2, p2 = tss.compile_stream_sharded(formula, 2)
    fa1, p1 = tss.compile_stream_sharded(formula, 1)
    mode = request.param
    two = spawn(sharded.run_stoch_clause, 1, 2, "gloo", "cpu", timeout_s=120,
                args=(fa2, 6, 8, 11, "float32", 8, mode))
    one = sharded.run_stoch_clause(None, "cpu", fa1, 6, 8, 11, "float32", 8, mode)
    return two, one, p2, p1


def test_stoch_clause_mesh_s2_equals_s1_flip_for_flip(s2_vs_s1):
    two, one, p2, p1 = s2_vs_s1
    np.testing.assert_array_equal(two[0], one[0])  # v
    np.testing.assert_array_equal(two[2], one[2])  # done
    # xl clause by clause: the two layouts order the clauses differently
    w2 = np.zeros((two[1].shape[0], p2.clause_of.max() + 1), np.int64)
    w1 = np.zeros_like(w2)
    w2[:, p2.clause_of[p2.clause_of >= 0]] = two[1][:, p2.clause_of >= 0]
    w1[:, p1.clause_of[p1.clause_of >= 0]] = one[1][:, p1.clause_of >= 0]
    np.testing.assert_array_equal(w2, w1)


def test_stoch_clause_mesh_moves(s2_vs_s1):
    """The run did something: flips happened and the weights grew."""
    two, _, _, _ = s2_vs_s1
    assert two[0].any() and two[1].max() > 1


def test_stoch_cli_clause_shards_easy_true_hard_false():
    from odesat_tpu_torch import cli

    easy = os.path.join(REPO, "tests", "data", "easy.cnf")
    hard = os.path.join(REPO, "tests", "data", "hard.cnf")
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["stoch", "-f", easy, "-b", "8", "-n", "2000", "--seed", "1",
                       "--device", "cpu", "--clause-shards", "2", "--dist-backend", "gloo"])
        rc2 = cli.main(["stoch", "-f", hard, "--no-preprocess", "-b", "4", "-n", "96",
                        "--chunk-steps", "32", "--seed", "0", "--device", "cpu",
                        "--devices", "2", "--clause-shards", "2", "--dist-backend", "gloo"])
    text = out.getvalue()
    assert rc == 0 and rc2 == 0
    verdicts = [ln for ln in text.splitlines() if ln.startswith("Checking if")]
    assert verdicts == ["Checking if solution vector satisfies formula: true",
                        "Checking if solution vector satisfies formula: false"]
    assert "Steps run: 96 | chains solved: 0/4" in text
