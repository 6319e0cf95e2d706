"""The port's checkpoint and resume (``odesat_tpu_torch/utils/checkpoint.py``)
against the JAX package's, the cases of tests/test_checkpoint.py.

* ODE snapshots load in either package: a run resumed by the other package
  continues as the writer's own resume does, float32 within rtol 2e-4 /
  atol 2e-5 (the twin's tolerance against JAX), float64 within rtol 1e-9 /
  atol 1e-12, with equal ``steps``.
* Stoch and hybrid snapshots cross neither way: the packages' random streams
  differ, and each refuses the other's with a clean ValueError.
* A resumed run equals the uninterrupted run with the same cadence bit for
  bit (every field of its final snapshot, ``steps``): ODE fixed and
  adaptive, stoch through the twin and through the kernels' plain version,
  the hybrid, and on a gloo mesh.
* Mesh layouts are checked as JAX checks them.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.cnf import parse_dimacs_file as jparse  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.config import SolverConfig as JSC  # noqa: E402
from odesat_tpu_torch import cli  # noqa: E402
from odesat_tpu_torch.cnf import normalize_cnf_variables, parse_dimacs_file  # noqa: E402
from odesat_tpu_torch.models.hybrid import hybrid_search  # noqa: E402
from odesat_tpu_torch.models.ode import ODEState, init_state, simulate_batch  # noqa: E402
from odesat_tpu_torch.models.stoch import StochState, search  # noqa: E402
from odesat_tpu_torch.utils import checkpoint as ck  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
import tests.torch_parity  # noqa: E402,F401  (thread count)

TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "float64": dict(rtol=1e-9, atol=1e-12)}


def _formula(data_dir, name):
    return normalize_cnf_variables(parse_dimacs_file(os.path.join(data_dir, name)))[1]


def _jformula(data_dir, name):
    return jnormalize(jparse(os.path.join(data_dir, name)))[1]


def _arrays(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _assert_same_snapshot(a, b):
    a, b = _arrays(a), _arrays(b)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_checkpoint_roundtrip(tmp_path, data_dir):
    from odesat_tpu_torch.cnf import compile_formula

    fa = compile_formula(_formula(data_dir, "small.cnf"), clause_pad=8, var_pad=8)
    state = init_state(fa, 4, torch.Generator().manual_seed(0), ODEConfig(), "cpu")
    path = str(tmp_path / "ckpt.npz")
    ck.save_state(path, state, steps=123)
    restored, steps, layout = ck.load_state(path, ODEState)
    assert steps == 123 and layout is None  # no mesh layout given
    for a, b in zip(state, restored):
        np.testing.assert_array_equal(a.numpy(), b)


def _ode_config(pkg, dtype, path, steps, every, resume=None):
    ode = dict(step_size=0.01, steps=steps, dtype=dtype)
    kw = dict(batch_size=4, seed=9, chunk_steps=16, checkpoint_path=path,
              checkpoint_every_chunks=every, resume_from=resume)
    return JSC(ode=JODE(**ode), **kw) if pkg == "jax" else SolverConfig(ode=ODEConfig(**ode), **kw)


def _run_ode(pkg, formula, config):
    if pkg == "jax":
        from odesat_tpu.models.ode import simulate_batch as jsimulate

        return jsimulate(formula, config)
    return simulate_batch(formula, config, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ode_snapshots_cross_load(tmp_path, data_dir, writer, dtype):
    """A snapshot written at 32 steps by one package, resumed to 64 by both:
    the final snapshots agree, and each package loads the other's."""
    reader = "torch" if writer == "jax" else "jax"
    formulas = {"jax": _jformula(data_dir, "hard.cnf"), "torch": _formula(data_dir, "hard.cnf")}
    part = str(tmp_path / "part.npz")
    _run_ode(writer, formulas[writer], _ode_config(writer, dtype, part, 32, 2))
    finals = {}
    for pkg in (writer, reader):
        finals[pkg] = str(tmp_path / f"{pkg}.npz")
        res = _run_ode(pkg, formulas[pkg], _ode_config(pkg, dtype, finals[pkg], 64, 2, part))
        assert res.steps == 64
    a, b = _arrays(finals[writer]), _arrays(finals[reader])
    assert int(a["steps"]) == int(b["steps"]) == 64
    assert tuple(a["mesh_layout"]) == tuple(b["mesh_layout"]) == (1, 1)
    for name in ("v", "xs", "xl", "dt"):
        np.testing.assert_allclose(a[f"field_{name}"], b[f"field_{name}"], **TOL[dtype],
                                   err_msg=name)
    np.testing.assert_array_equal(a["field_done"], b["field_done"])


def test_resume_accounts_the_snapshot_steps(tmp_path, data_dir):
    """A solve checkpointed mid-run and resumed counts the snapshot's steps
    against the budget; small batches keep the cadence (no chunk growth)."""
    formula = _formula(data_dir, "hard.cnf")
    path = str(tmp_path / "resume.npz")
    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=200), batch_size=4, seed=9,
                          chunk_steps=50, checkpoint_path=path, checkpoint_every_chunks=1)
    simulate_batch(formula, config, device="cpu")
    assert ck.load_state(path, ODEState)[1] == 200
    cadence = str(tmp_path / "cadence.npz")
    simulate_batch(formula, dataclasses.replace(
        config, ode=ODEConfig(step_size=0.01, steps=512), batch_size=8, chunk_steps=128,
        checkpoint_path=cadence, checkpoint_every_chunks=2), device="cpu")
    assert ck.load_state(cadence, ODEState)[1] == 512
    half = str(tmp_path / "half.npz")
    simulate_batch(formula, dataclasses.replace(config, ode=ODEConfig(step_size=0.01, steps=100),
                                                checkpoint_path=half), device="cpu")
    resumed = dataclasses.replace(config, resume_from=half, checkpoint_every_chunks=0)
    assert simulate_batch(formula, resumed, device="cpu").steps == 200


def _stoch_snapshot(tmp_path, data_dir, pkg):
    path = str(tmp_path / f"{pkg}_stoch.npz")
    if pkg == "jax":
        from odesat_tpu.models.stoch import search as jsearch

        jsearch(_jformula(data_dir, "hard.cnf"), JSC(
            ode=JODE(steps=32), batch_size=4, seed=0, chunk_steps=16, checkpoint_path=path,
            checkpoint_every_chunks=1))
    else:
        search(_formula(data_dir, "hard.cnf"), SolverConfig(
            ode=ODEConfig(steps=32), batch_size=4, seed=0, chunk_steps=16, checkpoint_path=path,
            checkpoint_every_chunks=1), device="cpu")
    return path


def test_stoch_snapshots_are_refused_across_packages(tmp_path, data_dir):
    """The packages' stoch random streams differ: each refuses the other's
    stoch snapshot cleanly."""
    from odesat_tpu.models.stoch import StochState as JStochState
    from odesat_tpu.models.stoch import search as jsearch
    from odesat_tpu.utils.checkpoint import load_state as jload

    jax_snap = _stoch_snapshot(tmp_path, data_dir, "jax")
    with pytest.raises(ValueError, match="random streams differ"):
        search(_formula(data_dir, "hard.cnf"), SolverConfig(
            ode=ODEConfig(steps=64), batch_size=4, seed=0, chunk_steps=16, resume_from=jax_snap),
            device="cpu")
    port_snap = _stoch_snapshot(tmp_path, data_dir, "torch")
    restored, steps, layout = ck.load_state(port_snap, StochState)
    assert steps == 32 and layout == (1, 1) and restored.v.shape[0] == 4
    with pytest.raises(ValueError, match="do not match StochState"):
        jload(port_snap, JStochState)
    with pytest.raises(ValueError, match="do not match StochState"):
        jsearch(_jformula(data_dir, "hard.cnf"), JSC(ode=JODE(steps=64), batch_size=4, seed=0,
                                                     chunk_steps=16, resume_from=port_snap))


def test_hybrid_snapshots_are_refused_across_packages(tmp_path, data_dir):
    from odesat_tpu.models.hybrid import hybrid_search as jhybrid
    from odesat_tpu.models.ode import ODEState as JODEState
    from odesat_tpu.models.stoch import StochState as JStochState
    from odesat_tpu.utils.checkpoint import load_hybrid_state as jload_hybrid

    jpath, tpath = str(tmp_path / "jax_h.npz"), str(tmp_path / "torch_h.npz")
    kw = dict(batch_size=4, seed=0, chunk_steps=16, checkpoint_every_chunks=1)
    jhybrid(_jformula(data_dir, "hard.cnf"), JSC(ode=JODE(step_size=0.01, steps=32),
                                                 checkpoint_path=jpath, **kw))
    hybrid_search(_formula(data_dir, "hard.cnf"), SolverConfig(
        ode=ODEConfig(step_size=0.01, steps=32), checkpoint_path=tpath, **kw), device="cpu")
    with pytest.raises(ValueError, match="random streams differ"):
        hybrid_search(_formula(data_dir, "hard.cnf"), SolverConfig(
            ode=ODEConfig(step_size=0.01, steps=64), resume_from=jpath, **kw), device="cpu")
    with pytest.raises(ValueError, match="engine version that wrote it"):
        jload_hybrid(tpath, JODEState, JStochState)
    ode, stoch, steps, layout = ck.load_hybrid_state(tpath, ODEState, StochState)
    assert steps == 32 and layout == (1, 1) and ode.v.shape[0] == stoch.v.shape[0] == 4


def _engine_run(engine, formula, config):
    if engine.startswith("ode"):
        return simulate_batch(formula, config, device="cpu")
    if engine.startswith("stoch"):
        return search(formula, config, device="cpu",
                      fused="on" if engine == "stoch-plain" else "auto")
    return hybrid_search(formula, config, device="cpu")


@pytest.mark.parametrize("engine", ["ode-fixed", "ode-adaptive", "stoch-twin", "stoch-plain",
                                    "hybrid"])
def test_resume_equals_the_uninterrupted_run(tmp_path, data_dir, engine):
    """Snapshot every chunk: a run stopped at 48 steps and resumed to 100
    (a tail of 4 steps) ends in the very snapshot of the run that never
    stopped, bit for bit."""
    formula = _formula(data_dir, "hard.cnf")
    ode = ODEConfig(step_size=None if engine == "ode-adaptive" else 0.01, steps=100)

    def config(path, steps, resume=None):
        return SolverConfig(ode=dataclasses.replace(ode, steps=steps), batch_size=4, seed=5,
                            chunk_steps=16, checkpoint_path=str(tmp_path / path),
                            checkpoint_every_chunks=1,
                            resume_from=None if resume is None else str(tmp_path / resume))

    whole = _engine_run(engine, formula, config("whole.npz", 100))
    _engine_run(engine, formula, config("part.npz", 48))
    resumed = _engine_run(engine, formula, config("resumed.npz", 100, "part.npz"))
    assert whole.steps == resumed.steps == 100
    _assert_same_snapshot(tmp_path / "whole.npz", tmp_path / "resumed.npz")
    extra = _arrays(tmp_path / "whole.npz")
    if engine != "ode-fixed" and engine != "ode-adaptive":
        assert extra["rng_cpu"].shape[0] == 1
        assert ("rng_device" in extra) == (engine in ("stoch-twin", "hybrid"))


def test_cross_engine_resume_rejected(tmp_path, data_dir):
    """An ODE snapshot resumed by the stoch engine, a hybrid snapshot by
    either, and a single-engine one by the hybrid: a clean ValueError."""
    from odesat_tpu_torch.cnf import compile_formula
    from odesat_tpu_torch.models.stoch import init_stoch_state

    fa = compile_formula(_formula(data_dir, "small.cnf"), clause_pad=8, var_pad=8)
    ode_state = init_state(fa, 4, torch.Generator().manual_seed(0), ODEConfig(), "cpu")
    ode_path, hyb_path = str(tmp_path / "ode.npz"), str(tmp_path / "hyb.npz")
    ck.save_state(ode_path, ode_state, steps=10)
    with pytest.raises(ValueError, match="do not match StochState"):
        ck.load_state(ode_path, StochState)
    ck.save_hybrid_state(hyb_path, ode_state, init_stoch_state(fa, 4, "cpu"), steps=10)
    with pytest.raises(ValueError, match="hybrid snapshot"):
        ck.load_state(hyb_path, ODEState)
    with pytest.raises(ValueError, match="single-engine snapshot"):
        ck.load_hybrid_state(ode_path, ODEState, StochState)


def test_hybrid_snapshot_field_mismatch_clean_error(tmp_path):
    path = str(tmp_path / "hybrid_bad.npz")
    np.savez(
        path,
        ode_fields=np.asarray(["v", "mystery"]),
        stoch_fields=np.asarray(list(StochState._fields)),
        ode_v=np.zeros((2, 4)),
        ode_mystery=np.zeros((2,)),
        steps=np.asarray(10),
        **{f"stoch_{f}": np.zeros((2,)) for f in StochState._fields},
    )
    with pytest.raises(ValueError, match="engine version that wrote it"):
        ck.load_hybrid_state(path, ODEState, StochState)


def test_mesh_layout_checks_match_jax():
    """The stoch (and hybrid) layout keeps the full (traj, clause) check; an
    ODE resume may change the traj width but not the clause width."""
    from odesat_tpu.utils.checkpoint import validate_mesh_layout as jvalidate

    for saved, traj_sensitive, ok in (((8, 1), True, False), ((8, 1), False, True),
                                      ((1, 2), False, False), ((1, 1), True, True), (None, True,
                                                                                      True)):
        for validate in (ck.validate_mesh_layout, jvalidate):
            if ok:
                validate(saved, None, what="x", traj_sensitive=traj_sensitive)
            else:
                with pytest.raises(ValueError, match="resume with the same") as e:
                    validate(saved, None, what="x", traj_sensitive=traj_sensitive)
                assert "cannot resume this x" in str(e.value)
    assert ck.mesh_layout_of(None) == (1, 1)


def test_layout_mismatch_refusals(tmp_path, data_dir):
    """A clause-mesh ODE snapshot, and a stoch snapshot of another traj
    width, are refused off a mesh; a stoch snapshot of per-row generators
    is refused by a run of another row count."""
    from odesat_tpu_torch.models.stoch import restore_generators

    formula = _formula(data_dir, "hard.cnf")
    path = str(tmp_path / "ode.npz")
    simulate_batch(formula, SolverConfig(ode=ODEConfig(step_size=0.01, steps=16), batch_size=4,
                                         seed=1, chunk_steps=16, checkpoint_path=path,
                                         checkpoint_every_chunks=1), device="cpu")
    arrays = _arrays(path)
    np.savez(str(tmp_path / "clause2.npz"), **{**arrays, "mesh_layout": np.asarray((1, 2))})
    np.savez(str(tmp_path / "traj2.npz"), **{**arrays, "mesh_layout": np.asarray((2, 1))})
    resume = SolverConfig(ode=ODEConfig(step_size=0.01, steps=32), batch_size=4, seed=1,
                          chunk_steps=16)
    with pytest.raises(ValueError, match="clause axis of the --devices/--clause-shards"):
        simulate_batch(formula, dataclasses.replace(
            resume, resume_from=str(tmp_path / "clause2.npz")), device="cpu")
    assert simulate_batch(formula, dataclasses.replace(
        resume, resume_from=str(tmp_path / "traj2.npz")), device="cpu").steps == 32
    stoch = _stoch_snapshot(tmp_path, data_dir, "torch")
    arrays = _arrays(stoch)
    np.savez(str(tmp_path / "stoch2.npz"), **{**arrays, "mesh_layout": np.asarray((2, 1))})
    with pytest.raises(ValueError, match="cannot resume this stoch snapshot"):
        search(formula, SolverConfig(ode=ODEConfig(steps=64), batch_size=4, seed=0,
                                     chunk_steps=16, resume_from=str(tmp_path / "stoch2.npz")),
               device="cpu")
    two_rows = {"rng_cpu": np.repeat(arrays["rng_cpu"], 2, axis=0)}
    with pytest.raises(ValueError, match="taken on a mesh"):
        restore_generators(two_rows, torch.Generator(), None)


@pytest.mark.parametrize("engine", ["inter", "stoch", "hybrid"])
def test_clause_mesh_resume_equals_the_uninterrupted_run(tmp_path, data_dir, capsys, engine):
    """On a 1x2 gloo mesh (B6 and B9's plain versions on the CPU): the
    uninterrupted run, a run stopped at 32 steps and its resume to 64 in one
    spawned world; the resumed final snapshot equals the uninterrupted one
    bit for bit, and the S=2 snapshot is refused off the mesh with JAX's
    message."""
    from odesat_tpu_torch.parallel import launch

    hard = os.path.join(data_dir, "hard.cnf")
    base = [engine, "-f", hard, "-b", "8", "--seed", "3", "--chunk-steps", "16",
            "--checkpoint-every", "1", "--device", "cpu"]
    if engine != "stoch":
        base += ["-s", "0.01"]
    if engine != "inter":
        base += ["--no-preprocess"]
    mesh = ["--clause-shards", "2", "--dist-backend", "gloo"]

    def argv(name, steps, resume=None):
        extra = ["--resume", str(tmp_path / resume)] if resume else []
        return [*base, "-n", str(steps), "--checkpoint", str(tmp_path / name), *extra]

    calls = [cli.mesh_call(argv("whole.npz", 64) + mesh + ["--profile-dir", str(tmp_path)]),
             cli.mesh_call(argv("part.npz", 32) + mesh),
             cli.mesh_call(argv("resumed.npz", 64, "part.npz") + mesh)]
    results = launch.spawn(launch.run_all, 1, 2, "gloo", "cpu", timeout_s=300, args=(calls,))
    assert [r.steps for r in results] == [64, 32, 64]
    _assert_same_snapshot(tmp_path / "whole.npz", tmp_path / "resumed.npz")
    for rank in (0, 1):  # each rank traces its own loop
        assert os.path.getsize(tmp_path / f"trace_rank{rank}.json") > 0
    snap = _arrays(tmp_path / "part.npz")
    assert tuple(snap["mesh_layout"]) == (1, 2)
    xl = snap["ode_xl" if engine == "hybrid" else "field_xl"]
    assert xl.shape[0] == 8  # the whole batch, both clause segments
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        cli.main(argv("again.npz", 64, "part.npz"))
    assert e.value.code == 2
    assert "was taken on a (traj=1, clause=2) mesh but this run uses (traj=1, clause=1)" in \
        capsys.readouterr().err


@pytest.mark.parametrize("cmd, args", [
    ("solve", ["-n", "64", "-s", "0.01", "--solve-batch", "4"]),
    ("batch", ["-n", "64", "-s", "0.01", "-b", "4"]),
    ("inter", ["-n", "64", "-s", "0.01", "-b", "4"]),
    ("stoch", ["-n", "64", "-b", "4", "--no-preprocess"]),
    ("hybrid", ["-n", "64", "-s", "0.01", "-b", "4", "--no-preprocess"]),
])
def test_cli_snapshot_resume_and_profile_flags(data_dir, tmp_path, capsys, cmd, args):
    """Every solver subcommand takes --checkpoint/--checkpoint-every,
    --resume and --profile-dir: the snapshot holds the budget's steps, the
    resumed run picks up its counter, the trace names the loop's ops."""
    hard = os.path.join(data_dir, "hard.cnf")
    path, prof = str(tmp_path / "s.npz"), str(tmp_path / "prof")
    base = [cmd, "-f", hard, *args, "--seed", "4", "--chunk-steps", "16", "--device", "cpu"]
    assert cli.main([*base, "--checkpoint", path, "--checkpoint-every", "1",
                     "--profile-dir", prof]) == 0
    assert int(_arrays(path)["steps"]) == 64
    assert os.path.getsize(os.path.join(prof, "trace_rank0.json")) > 0
    assert cli.main([*base[:-2], "-n", "96", "--device", "cpu", "--resume", path]) == 0
    out = capsys.readouterr().out
    assert "Checking if solution vector satisfies formula: false" in out
    assert ("after 96 steps per engine" if cmd == "hybrid" else "Steps run: 96 |") in out
