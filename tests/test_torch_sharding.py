"""The ODE engine on a mesh (odesat_tpu_torch/parallel/), on the CPU with
gloo ranks spawned by ``parallel/launch.spawn``.

* The clause mesh end to end, T x S = 1x2 and 2x2, fixed and adaptive, 6
  steps through the plain versions of B6 (the clause-sharded chunk,
  ``shard_chunk='auto'``) and of B5 (the per-step path, 'off'): against the
  JAX package's scan path (``make_chunk_runner`` with ``segment_sum``) on
  the same FormulaArrays, as tests/test_shard_stream.py:121-164 does; rtol
  2e-4 / atol 2e-5, done exactly (the two sum dv in other orders); B6
  against B5 bit for bit.
* The twin's clause step in float64 on a plain layout: against the JAX
  single-device scan to 1e-12.
* A trajectory-only mesh (T=2): bit-identical to the T=1 run, row by row.
* The CLI's mesh flags, the backend rules of ``initialize_distributed``,
  and workers that import no jax.
"""

import contextlib
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables  # noqa: E402
from odesat_tpu.models import ode as jode  # noqa: E402
from odesat_tpu.ops.shard_stream import compile_stream_sharded as jcompile_sharded  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.generate import random_ksat  # noqa: E402
from odesat_tpu_torch import cli  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy, rank_block  # noqa: E402
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.parallel import launch, multihost, sharded  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from tests.test_torch_shard_stream import _mixed_width_formula  # noqa: E402
from tests.torch_parity import jax_state, numpy_state  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZETA = 0.001
STEPS = 6
F32 = dict(rtol=2e-4, atol=2e-5)
MODES = {"fixed": dict(step_size=0.01), "adaptive": dict(tolerance=1e-3)}


def _cases():
    """(label, port fa, JAX fa, kw, arrays) for the clause-mesh comparisons."""
    normalized = _mixed_width_formula(seed=23, counts=(60, 260, 60))
    jfa, _ = jcompile_sharded(normalized, 2)
    arrays = numpy_state(jfa, 8, seed=3)
    return normalized, jfa, arrays


@pytest.fixture(scope="module")
def clause_runs():
    """Both integrators on a 1x2 and a 2x2 gloo world (one spawn each)
    through B6 and through B5, the f64 twin, and the JAX references. Case
    order: B6 fixed, adaptive; twin f64 fixed, adaptive; B5 fixed,
    adaptive."""
    normalized, jfa, arrays = _cases()
    tfa = formula_arrays_from_numpy(jfa)
    cases = [(tfa, ZETA, ODEConfig(dv_strategy="stream", **kw), STEPS, arrays)
             for kw in MODES.values()]
    # the twin's clause step: float64 on the plain (unbucketed) layout
    jplain = jcompile(normalized, dtype=np.float64, clause_pad=256)
    arrays64 = numpy_state(jplain, 8, seed=5, dtype=np.float64)
    tplain = formula_arrays_from_numpy(jplain)
    cases.append((tplain, ZETA, ODEConfig(step_size=0.01, dtype="float64"), STEPS, arrays64))
    cases.append((tplain, ZETA, ODEConfig(tolerance=1e-3, dtype="float64"), STEPS, arrays64))
    cases += [(tfa, ZETA, ODEConfig(dv_strategy="stream", shard_chunk="off", **kw), STEPS, arrays)
              for kw in MODES.values()]
    runs = {shape: launch.spawn(sharded.run_ode_cases, *shape, "gloo", "cpu", timeout_s=180,
                                args=(cases,))
            for shape in ((1, 2), (2, 2))}
    refs = []
    for kw in MODES.values():
        run = jode.make_chunk_runner(jfa, ZETA, JODE(dv_strategy="segment_sum", **kw), STEPS)
        refs.append(run(jax_state(arrays), jode.formula_device(jfa)))
    for kw in (dict(step_size=0.01), dict(tolerance=1e-3)):
        run = jode.make_chunk_runner(jplain, ZETA,
                                     JODE(dv_strategy="segment_sum", dtype="float64", **kw), STEPS)
        out = run(jax_state(arrays64), jode.formula_device(jplain, dtype=np.float64))
        refs.append(tuple(np.asarray(t) for t in out))
    return runs, refs, launch.last_reports


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("path", ["chunk", "step"])
def test_clause_mesh_matches_jax_scan(clause_runs, shape, mode, path):
    runs, refs, _ = clause_runs
    i = list(MODES).index(mode)
    out, ref = runs[shape][i + (4 if path == "step" else 0)], refs[i]
    for name, a, b in zip(("v", "xs", "xl"), out[:3], ref[:3]):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **F32)
    np.testing.assert_array_equal(out[4], np.asarray(ref[4]))
    if mode == "adaptive":
        np.testing.assert_allclose(out[3], np.asarray(ref[3]), rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_twin_clause_step_f64_matches_jax_scan(clause_runs, mode):
    runs, refs, _ = clause_runs
    i = 2 + ["fixed", "adaptive"].index(mode)
    out, ref = runs[(2, 2)][i], refs[i]
    for name, a, b in zip(("v", "xs", "xl", "dt"), out[:4], ref[:4]):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(out[4], ref[4])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("mode", list(MODES))
def test_clause_mesh_chunk_equals_step_path(clause_runs, shape, mode):
    """B6's schedule on a mesh computes what B5's per-step path does, bit
    for bit, on every rank's block."""
    runs, _, _ = clause_runs
    i = list(MODES).index(mode)
    for a, b in zip(runs[shape][i], runs[shape][i + 4]):
        np.testing.assert_array_equal(a, b)


def test_clause_mesh_keeps_v_replicated(clause_runs):
    """Both clause ranks of the first row ended every case with the same v,
    bit for bit (the runs also check every row themselves and raise
    otherwise); on the CPU the wrappers ran the plain versions, so no rank
    counted a kernel launch."""
    runs, _, reports = clause_runs
    assert len(reports) == 4
    assert all(r["shard_stream"] == 0 and r["shard_chunk"] == 0 for r in reports)
    for shape in runs:
        for out in runs[shape]:
            copies = out[5]
            assert copies.shape[0] == 2
            np.testing.assert_array_equal(copies[0], copies[1])


def test_trajectory_mesh_is_bit_identical_to_one_device():
    """T=2, S=1 through the CLI's solve path: every row as at T=1."""
    from odesat_tpu_torch.cnf import normalize_cnf_variables as tnorm
    from odesat_tpu_torch.utils.config import SolverConfig
    from odesat_tpu_torch.utils.generate import random_ksat as trandom

    formula = tnorm(trandom(60, 250, seed=4))[1]
    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=300), batch_size=8, seed=7,
                          chunk_steps=64)
    one = tode.simulate_batch(formula, config, device="cpu", stop_on="all")
    two = launch.spawn(cli._mesh_solve, 2, 1, "gloo", "cpu", timeout_s=120,
                       args=("ode", formula, config, {"stop_on": "all"}))
    np.testing.assert_array_equal(two.assignment, one.assignment)
    np.testing.assert_array_equal(two.done, one.done)
    assert two.steps == one.steps


def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    return rc, out.getvalue()


MESH = ("--device", "cpu", "--clause-shards", "2", "--dist-backend", "gloo")


@pytest.mark.parametrize("cmd,name,extra,verdict", [
    ("solve", "small", ("-s", "0.01", "-n", "2000"), "true"),
    ("solve", "easy", ("-n", "4000", "--chunk-steps", "64"), "true"),
    ("inter", "easy", ("-b", "8", "-s", "0.01", "-n", "2000"), "true"),
    ("inter", "hard", ("-b", "4", "-s", "0.01", "-n", "96", "--chunk-steps", "32"), "false"),
    ("batch", "small", ("-b", "8", "-s", "0.01", "-n", "1000"), "true"),
])
def test_cli_clause_shards(cmd, name, extra, verdict):
    path = os.path.join(REPO, "tests", "data", f"{name}.cnf")
    rc, text = _cli(cmd, "-f", path, "--seed", "1", *extra, *MESH)
    assert rc == 0
    assert f"Checking if solution vector satisfies formula: {verdict}" in text
    if name == "hard":
        assert "Steps run: 96 | trajectories solved: 0/4" in text


def test_cli_mesh_errors_exit_2(capsys):
    easy = os.path.join(REPO, "tests", "data", "easy.cnf")
    with pytest.raises(SystemExit) as e:
        _cli("inter", "-f", easy, "-b", "8", "-n", "10", "--device", "cpu", "--clause-shards", "2")
    assert e.value.code == 2  # --device cpu needs gloo
    assert "gloo" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        _cli("inter", "-f", easy, "-b", "8", "-n", "10", "--device", "cpu", "--devices", "0")
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:  # 6 rows do not split over 4 trajectory ranks
        _cli("inter", "-f", easy, "-b", "6", "-n", "10", "--seed", "0", "--device", "cpu",
             "--devices", "4", "--dist-backend", "gloo")
    assert e.value.code == 2
    assert "divide" in capsys.readouterr().err


def test_initialize_distributed_rules(monkeypatch, tmp_path):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert multihost.initialize_distributed("gloo", "cpu") is None  # no world described
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="half-set"):
        multihost.initialize_distributed("gloo", "cpu")
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="dist-backend gloo"):
        multihost.initialize_distributed("nccl", "cuda", rank=0, world_size=2,
                                         store_path=str(tmp_path / "store"))
    with pytest.raises(ValueError, match="gloo"):
        multihost.check_backend("nccl", "cpu", 1)
    with pytest.raises(ValueError, match="store_path"):
        multihost.initialize_distributed("gloo", "cpu", rank=0, world_size=2)


def test_spawned_workers_import_no_jax():
    seen = launch.spawn(launch.probe, 1, 2, "gloo", "cpu", timeout_s=120)
    assert seen == {"rank": 0, "shape": {"traj": 1, "clause": 2}, "device": "cpu",
                    "jax": False, "odesat_tpu": False}


def test_failed_worker_raises():
    """A rank that raises makes spawn kill the others and raise; a
    ValueError keeps its message (the CLI turns it into exit 2)."""
    fa = formula_arrays_from_numpy(jcompile(normalize_cnf_variables(random_ksat(10, 30, seed=0))[1]))
    case = (fa, ZETA, ODEConfig(step_size=0.01), 1, numpy_state(fa, 3, seed=0))
    with pytest.raises(ValueError, match="3 rows do not divide"):
        launch.spawn(sharded.run_ode_cases, 2, 1, "gloo", "cpu", timeout_s=120, args=([case],))


def test_rank_block_cuts_rows_and_segments():
    a = np.arange(4 * 6).reshape(4, 6)
    np.testing.assert_array_equal(rank_block(a, 2, 3, 1, 2, clause_sharded=True), [[16, 17],
                                                                                    [22, 23]])
    np.testing.assert_array_equal(rank_block(a, 2, 3, 0, 1), a[:2])


@pytest.mark.parametrize("case", ["stream-without-plan", "fused", "plan-mismatch",
                                  "bucketed-twin"])
def test_clause_mesh_runner_refusals(case):
    """What a clause mesh cannot run raises before any collective, as the
    JAX runner does (sharded.py:433-482, models/ode.py:216-226)."""
    from types import SimpleNamespace

    from odesat_tpu_torch.cnf import compile_formula as tcompile
    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded as tsharded
    from tests.torch_parity import port_formula

    normalized = port_formula(_mixed_width_formula(seed=29, counts=(60, 260, 60)))
    # every refusal comes before the first collective, so a stand-in group
    mesh = SimpleNamespace(n_traj=1, n_clause=2, clause_group=object(), traj_group=None)
    if case == "stream-without-plan":
        fa, ode, match = tcompile(normalized), ODEConfig(step_size=0.01, dv_strategy="stream"), \
            "clause mesh needs a formula compiled via compile_for_mesh"
    elif case == "fused":
        fa, ode, match = tsharded(normalized, 2)[0], ODEConfig(dv_strategy="fused"), \
            "does not support a clause mesh"
    elif case == "plan-mismatch":
        fa, ode, match = tsharded(normalized, 4)[0], ODEConfig(step_size=0.01), \
            "plan has 4 shards but the mesh 2"
    else:
        fa, ode, match = tcompile(normalized, bucket=True), ODEConfig(step_size=0.01), \
            "width-bucketed formulas need the clause-shard kernel"
    with pytest.raises(ValueError, match=match):
        sharded.make_sharded_chunk_runner(fa, ZETA, ode, 4, mesh, "cpu")


def test_stoch_trajectory_mesh_cli():
    rc, text = _cli("stoch", "-f", os.path.join(REPO, "tests", "data", "easy.cnf"), "-b", "8",
                    "-n", "2000", "--seed", "3", "--devices", "2", "--dist-backend", "gloo",
                    "--device", "cpu")
    assert rc == 0
    assert "Checking if solution vector satisfies formula: true" in text


def test_run_all_runs_several_calls_in_one_world():
    """``launch.run_all`` returns rank 0's value of each call, in order."""
    seen = launch.spawn(launch.run_all, 1, 2, "gloo", "cpu", timeout_s=120,
                        args=([(launch.probe, ()), (launch.probe, ())],))
    assert [s["shape"] for s in seen] == [{"traj": 1, "clause": 2}] * 2
