"""The ODE engine on a mesh (odesat_tpu_torch/parallel/), on the CPU with
gloo ranks spawned by ``parallel/launch.spawn``.

* The clause mesh end to end, T x S = 1x2, 2x2 and 1x4, fixed and
  adaptive, 6 steps through the plain versions of B6 (the clause-sharded
  chunk, ``shard_chunk='auto'``) and of B5 (the per-step path, 'off'):
  against the JAX package's scan path (``make_chunk_runner`` with
  ``segment_sum``) on the same FormulaArrays, as
  tests/test_shard_stream.py:121-164 does; rtol 2e-4 / atol 2e-5, done
  exactly (the two sum dv in other orders); B6 against B5 bit for bit.
* The twin's clause step, whose sums and maxima run through B7's
  standalone call (its plain version on the CPU) at 1x2, 2x2 and 1x4:
  float64 fixed and adaptive on a plain layout, and a batch-shared
  adaptive dt (its error max also over the trajectory group at 2x2),
  against the JAX single-device scan to 1e-12; float32 with unit clauses
  (infinite gradients) fixed and adaptive within rtol 2e-4 / atol 2e-5
  (dt rtol 2e-4 / atol 2e-6), done exactly.
* A trajectory-only mesh (T=2): bit-identical to the T=1 run, row by row;
  with a batch-shared adaptive dt (the twin's error max over the
  trajectory group), bit-identical to the port's one-device run and within
  1e-12 of JAX's.
* Where the twin step's trajectory-group max reduces
  (``sharded.traj_reduce_route``): B7 within one host, torch.distributed
  over hosts, logged.
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
from odesat_tpu.cnf.formula import CNFFormula, Literal  # noqa: E402
from odesat_tpu.models import ode as jode  # noqa: E402
from odesat_tpu.ops.shard_stream import compile_stream_sharded as jcompile_sharded  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.generate import random_ksat  # noqa: E402
from odesat_tpu_torch import cli  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy, rank_block  # noqa: E402
from odesat_tpu_torch.interop import state_from_numpy  # noqa: E402
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


def _with_units(normalized):
    """The formula with three unit clauses on distinct variables: the
    twin's infinite gradients, which B7 sums like any other value."""
    units = [(Literal(v, neg),) for v, neg in ((1, False), (5, True), (9, False))]
    return CNFFormula(list(normalized.clauses) + units, normalized.varnum)


# the twin's cases after B6's and B5's (cases 6 on): their JAX configs
TWIN = {"f32 units fixed": dict(step_size=0.01),
        "f32 units adaptive": dict(tolerance=1e-3),
        "f64 shared": dict(tolerance=1e-3, dt_mode="shared", dtype="float64")}
SHAPES = [(1, 2), (2, 2), (1, 4)]
F64 = dict(rtol=1e-12, atol=1e-12)


def _jax_run(jfa, kw, arrays):
    dtype = np.float64 if kw.get("dtype") == "float64" else np.float32
    run = jode.make_chunk_runner(jfa, ZETA, JODE(dv_strategy="segment_sum", **kw), STEPS)
    out = run(jax_state(arrays), jode.formula_device(jfa, dtype=dtype))
    return tuple(np.asarray(t) for t in out)


@pytest.fixture(scope="module")
def clause_runs():
    """Both integrators on a 1x2, a 2x2 and a 1x4 gloo world (one spawn
    each) through B6 and through B5, the twin's clause step (f64, f32 with
    unit clauses, a batch-shared dt), a 2x1 mesh with a batch-shared dt in
    the 1x2 world, and the JAX references. Case order: B6 fixed, adaptive;
    twin f64 fixed, adaptive; B5 fixed, adaptive; then TWIN's."""
    normalized, jfa, arrays = _cases()
    # the twin's clause step: float64 on the plain (unbucketed) layout
    jplain = jcompile(normalized, dtype=np.float64, clause_pad=256)
    arrays64 = numpy_state(jplain, 8, seed=5, dtype=np.float64)
    tplain = formula_arrays_from_numpy(jplain)
    junits = jcompile(_with_units(normalized), clause_pad=256)
    arrays_u = numpy_state(junits, 8, seed=6)
    tunits = formula_arrays_from_numpy(junits)
    twin = [(tunits, ZETA, ODEConfig(**TWIN["f32 units fixed"]), STEPS, arrays_u),
            (tunits, ZETA, ODEConfig(**TWIN["f32 units adaptive"]), STEPS, arrays_u),
            (tplain, ZETA, ODEConfig(**TWIN["f64 shared"]), STEPS, arrays64)]

    def cases(jfa_s, arrays_s):
        tfa = formula_arrays_from_numpy(jfa_s)
        out = [(tfa, ZETA, ODEConfig(dv_strategy="stream", **kw), STEPS, arrays_s)
               for kw in MODES.values()]
        out.append((tplain, ZETA, ODEConfig(step_size=0.01, dtype="float64"), STEPS, arrays64))
        out.append((tplain, ZETA, ODEConfig(tolerance=1e-3, dtype="float64"), STEPS, arrays64))
        out += [(tfa, ZETA, ODEConfig(dv_strategy="stream", shard_chunk="off", **kw), STEPS,
                 arrays_s) for kw in MODES.values()]
        return out + twin

    jfa4, _ = jcompile_sharded(normalized, 4)
    arrays4 = numpy_state(jfa4, 8, seed=3)
    layouts = {2: (jfa, arrays), 4: (jfa4, arrays4)}
    runs, traj_shared = {}, None
    for shape in SHAPES:
        calls = [(sharded.run_ode_cases, (cases(*layouts[shape[1]]),))]
        if shape == (1, 2):  # a trajectory mesh of the same world, batch-shared dt
            calls.append((launch.on_mesh, ((2, 1), sharded.run_ode_cases, [twin[-1]])))
        values = launch.spawn(launch.run_all, *shape, "gloo", "cpu", timeout_s=240,
                              args=(calls,))
        runs[shape] = values[0]
        if shape == (1, 2):
            (traj_shared,) = values[1]
    refs = {S: [_jax_run(jfa_s, kw, arrays_s) for kw in MODES.values()]
            for S, (jfa_s, arrays_s) in layouts.items()}
    twin_refs = [_jax_run(jplain, dict(dtype="float64", **kw), arrays64)
                 for kw in MODES.values()]
    twin_refs += [_jax_run(junits, TWIN[k], arrays_u) for k in list(TWIN)[:2]]
    twin_refs.append(_jax_run(jplain, TWIN["f64 shared"], arrays64))
    one = tode.make_chunk_runner(tplain, ZETA, ODEConfig(**TWIN["f64 shared"]), STEPS, "cpu")(
        state_from_numpy(*arrays64, device="cpu"),
        tode.formula_device(tplain, "cpu", dtype=torch.float64))
    return dict(runs=runs, refs=refs, twin_refs=twin_refs, reports=launch.last_reports,
                traj_shared=traj_shared, one_shared=tuple(t.numpy() for t in one))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("path", ["chunk", "step"])
def test_clause_mesh_matches_jax_scan(clause_runs, shape, mode, path):
    i = list(MODES).index(mode)
    out = clause_runs["runs"][shape][i + (4 if path == "step" else 0)]
    ref = clause_runs["refs"][shape[1]][i]
    for name, a, b in zip(("v", "xs", "xl"), out[:3], ref[:3]):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **F32)
    np.testing.assert_array_equal(out[4], np.asarray(ref[4]))
    if mode == "adaptive":
        np.testing.assert_allclose(out[3], np.asarray(ref[3]), rtol=2e-4, atol=2e-6)


def _twin_close(out, ref, tol, dt_tol):
    for name, a, b in zip(("v", "xs", "xl"), out[:3], ref[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, err_msg=name, **tol)
    np.testing.assert_allclose(out[3], ref[3], err_msg="dt", **dt_tol)
    np.testing.assert_array_equal(out[4], ref[4])


@pytest.mark.parametrize("mode,shape", [
    pytest.param("fixed", (2, 2), id="fixed"), pytest.param("adaptive", (2, 2), id="adaptive"),
    pytest.param("fixed", (1, 2), id="1x2-fixed"),
    pytest.param("adaptive", (1, 2), id="1x2-adaptive"),
    pytest.param("fixed", (1, 4), id="1x4-fixed"),
    pytest.param("adaptive", (1, 4), id="1x4-adaptive"),
])
def test_twin_clause_step_f64_matches_jax_scan(clause_runs, mode, shape):
    i = ["fixed", "adaptive"].index(mode)
    out, ref = clause_runs["runs"][shape][2 + i], clause_runs["twin_refs"][i]
    assert out[0].dtype == np.float64
    _twin_close(out, ref, F64, F64)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(MODES))
def test_twin_clause_step_f32_unit_clauses_matches_jax_scan(clause_runs, shape, mode):
    """Unit clauses keep the twin (B5's and B6's gate refuses them): their
    infinite gradients go through B7's sum like any other partial."""
    i = list(MODES).index(mode)
    out, ref = clause_runs["runs"][shape][6 + i], clause_runs["twin_refs"][2 + i]
    assert out[0].dtype == np.float32
    _twin_close(out, ref, F32, dict(rtol=2e-4, atol=2e-6))


@pytest.mark.parametrize("shape", SHAPES)
def test_twin_clause_step_shared_dt_matches_jax_scan(clause_runs, shape):
    """A batch-shared adaptive dt: the error max over the clause group,
    then (2x2) over the trajectory group, both through B7."""
    out, ref = clause_runs["runs"][shape][8], clause_runs["twin_refs"][4]
    _twin_close(out, ref, F64, F64)
    assert np.unique(out[3]).size == 1  # one dt for the whole batch


def test_trajectory_mesh_shared_dt_matches_one_device(clause_runs):
    """T=2, S=1 with a batch-shared adaptive dt (the twin's error max over
    the trajectory group through B7's plain version): the port's one-device
    run bit for bit, JAX's within 1e-12."""
    out, one = clause_runs["traj_shared"], clause_runs["one_shared"]
    for a, b in zip(out[:5], one):
        np.testing.assert_array_equal(a, b)
    _twin_close(out, clause_runs["twin_refs"][4], F64, F64)


def test_traj_reduce_route_decides_by_the_groups_hosts(caplog):
    from types import SimpleNamespace

    assert sharded.traj_reduce_route(2, "cpu", ())[0] == "b7"
    assert sharded.traj_reduce_route(2, "cuda", ("a", "a"))[0] == "b7"
    assert sharded.traj_reduce_route(1, "cuda", ("a",))[0] == "b7"
    route, why = sharded.traj_reduce_route(2, "cuda", ("a", "b"))
    assert route == "dist" and "spans hosts ['a', 'b']" in why
    mesh = SimpleNamespace(n_traj=2, n_clause=2, traj_group=object())
    with caplog.at_level("INFO", logger="odesat_tpu_torch"):
        routes = sharded.twin_routes(mesh, "cpu", shared=True)
    assert routes == {"clause_route": "b7", "traj_route": "b7"}
    assert "shared-dt max over the trajectory group -> b7 on cpu" in caplog.text
    assert sharded.twin_routes(mesh, "cpu", shared=False) == routes


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(MODES))
def test_clause_mesh_chunk_equals_step_path(clause_runs, shape, mode):
    """B6's schedule on a mesh computes what B5's per-step path does, bit
    for bit, on every rank's block."""
    i = list(MODES).index(mode)
    runs = clause_runs["runs"]
    for a, b in zip(runs[shape][i], runs[shape][i + 4]):
        np.testing.assert_array_equal(a, b)


def test_clause_mesh_keeps_v_replicated(clause_runs):
    """Every clause rank of the first row ended every case with the same v,
    bit for bit (the runs also check every row themselves and raise
    otherwise); on the CPU the wrappers ran the plain versions, so no rank
    counted a kernel launch."""
    runs, reports = clause_runs["runs"], clause_runs["reports"]
    assert len(reports) == 4
    assert all(r["shard_stream"] == 0 and r["shard_chunk"] == 0 and r["butterfly"] == 0
               and r["butterfly_f64"] == 0 for r in reports)
    for shape in runs:
        for out in runs[shape]:
            copies = out[5]
            assert copies.shape[0] == shape[1]
            for c in copies[1:]:
                np.testing.assert_array_equal(copies[0], c)


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
    assert [len(r["calls"]) for r in launch.last_reports] == [2, 2]  # each call's counts


def _bump(mesh, device, n):
    """A call that counts ``n`` B6 launches (the wrappers count only on a card)."""
    from odesat_tpu_torch.ops import shard_chunk

    shard_chunk.launches += n
    return n


def test_run_all_counts_each_call_on_its_own(monkeypatch):
    """``run_all`` sets every launch count to 0 before each call and keeps
    each call's own; a rank reports their sum and each call's."""
    import importlib

    for _, mod, attr in launch._COUNTERS:  # counts from before the calls
        module = importlib.import_module(mod)
        monkeypatch.setattr(module, attr, getattr(module, attr) + 7)
    monkeypatch.setattr(launch, "call_reports", [])
    assert launch.run_all(None, "cpu", [(_bump, (3,)), (_bump, (0,)), (_bump, (2,))]) == [3, 0, 2]
    calls = launch._rank_report()["calls"]
    assert [c["shard_chunk"] for c in calls] == [3, 0, 2]
    assert not any(n for c in calls for k, n in c.items() if k != "shard_chunk")
    assert launch._rank_report()["shard_chunk"] == 5


@pytest.mark.parametrize("cmd,extra", [
    ("inter", ("-b", "8", "-s", "0.01", "-n", "300", "--chunk-steps", "64")),
    ("stoch", ("-b", "8", "-n", "300", "--chunk-steps", "64")),
])
def test_mesh_call_is_the_cli_mesh_solve(cmd, extra):
    """``cli.mesh_call`` hands a ``run_all`` world what the CLI's own spawn
    runs: the same steps and solved rows as the CLI with the same flags."""
    argv = [cmd, "-f", os.path.join(REPO, "tests", "data", "easy.cnf"), "--seed", "1", *extra,
            *MESH]
    with contextlib.redirect_stdout(io.StringIO()):
        call = cli.mesh_call(argv)
    (result,) = launch.spawn(launch.run_all, 1, 2, "gloo", "cpu", timeout_s=120, args=([call],))
    rc, text = _cli(*argv)
    assert rc == 0
    what = "chains" if cmd == "stoch" else "trajectories"
    assert (f"Steps run: {result.steps} | {what} solved: {int(result.done.sum())}"
            f"/{result.done.size}") in text


def test_mesh_call_refuses_as_the_cli_does(capsys):
    easy = os.path.join(REPO, "tests", "data", "easy.cnf")
    with pytest.raises(SystemExit) as e:
        cli.mesh_call(["inter", "-f", easy, "-b", "8", "--shard-chunk", "--device", "cpu"])
    assert e.value.code == 2
    assert "--clause-shards >= 2" in capsys.readouterr().err


def test_on_mesh_runs_another_mesh_in_the_same_world():
    """``launch.on_mesh`` inside ``run_all``: a 2x1 mesh solve in a world
    spawned as 1x2 equals the one-device run row for row, beside a 1x2
    call and an all-reduce timing (the world chip_smoke.py's phase 20
    spawns once)."""
    from odesat_tpu_torch.cnf import normalize_cnf_variables as tnorm
    from odesat_tpu_torch.parallel.dist import time_all_reduce
    from odesat_tpu_torch.utils.config import SolverConfig
    from odesat_tpu_torch.utils.generate import random_ksat as trandom

    formula = tnorm(trandom(60, 250, seed=4))[1]
    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=300), batch_size=8, seed=7,
                          chunk_steps=64)
    calls = [(launch.probe, ()), (launch.on_mesh, ((2, 1), launch.probe)),
             (launch.on_mesh, ((2, 1), cli._mesh_solve, "ode", formula, config,
                               {"stop_on": "all"})),
             (time_all_reduce, ((4, 9), 2))]
    seen, other, two, ms = launch.spawn(launch.run_all, 1, 2, "gloo", "cpu", timeout_s=120,
                                        args=(calls,))
    assert seen["shape"] == {"traj": 1, "clause": 2}
    assert other["shape"] == {"traj": 2, "clause": 1}
    one = tode.simulate_batch(formula, config, device="cpu", stop_on="all")
    np.testing.assert_array_equal(two.assignment, one.assignment)
    np.testing.assert_array_equal(two.done, one.done)
    assert two.steps == one.steps and ms > 0
