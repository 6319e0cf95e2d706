"""The port's hybrid portfolio (``odesat_tpu_torch/models/hybrid.py`` and the
``hybrid`` subcommand) against the JAX package's.

* The CLI's ``Winner:`` engine, steps and verdict on small, easy and
  hard.cnf equal the JAX CLI's (exact string equality of those lines but
  the seconds); hard.cnf ends ``false`` after exactly a budget that is no
  multiple of the chunk.
* A tie goes to the ODE engine; a stoch win reads out a stoch chain.
* The compiled ``FormulaArrays`` are array-equal to the JAX hybrid's, on
  one device and for a 1x2 mesh.
* A gloo mesh, T=2 x S=2, agrees with one device: same winner, steps and
  verdict; on hard.cnf the ODE engine's v within rtol 2e-4 / atol 2e-5
  (the clause-sharded chunk's plain version against the twin, which sum dv
  in other orders) and its done flags equal.
"""

import dataclasses
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu import cli as jcli  # noqa: E402
from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.cnf import parse_dimacs_file as jparse  # noqa: E402
from odesat_tpu.utils.config import SolverConfig as JSC  # noqa: E402
from odesat_tpu_torch import cli  # noqa: E402
from odesat_tpu_torch.cnf import CNFFormula, Literal, evaluate_cnf  # noqa: E402
from odesat_tpu_torch.cnf import normalize_cnf_variables, parse_dimacs_file  # noqa: E402
from odesat_tpu_torch.models.hybrid import HybridState, hybrid_arrays, hybrid_search  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
import tests.torch_parity  # noqa: E402,F401  (thread count)

F32 = dict(rtol=2e-4, atol=2e-5)


def _lines(out):
    """The Winner line without its seconds, and the verdict line."""
    winner = re.search(r"Winner: (\w+) after (\d+) steps per engine", out)
    verdict = re.search(r"Checking if solution vector satisfies formula: (true|false)", out)
    assert winner and verdict, out
    return winner.groups(), verdict.group(1)


CASES = [
    ("small.cnf", ["-b", "16", "-n", "2000", "--seed", "0"], ("ode", "256"), "true"),
    ("easy.cnf", ["-b", "16", "-n", "2000", "--seed", "0"], ("ode", "256"), "true"),
    ("hard.cnf", ["-b", "8", "-n", "100", "--chunk-steps", "16", "-s", "0.01", "--seed", "0",
                  "--no-preprocess"], ("none", "100"), "false"),
]


@pytest.mark.parametrize("name, args, winner, verdict", CASES)
def test_cli_winner_and_verdict_equal_jax(data_dir, capsys, name, args, winner, verdict):
    argv = ["hybrid", "-f", os.path.join(data_dir, name), *args]
    assert jcli.main(argv) == 0
    jax_lines = _lines(capsys.readouterr().out)
    assert cli.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Racing ODE and stochastic engines..." in out
    assert _lines(out) == jax_lines == (winner, verdict)


def test_a_tie_goes_to_the_ode_engine(monkeypatch):
    """(x0 or x1): the stoch chains flip both variables on their first step
    (every weight unsatisfied), the ODE rows solve within the chunk too;
    with both batches done after the first pair of chunks, "ode" wins."""
    from odesat_tpu_torch.models import loop

    formula = CNFFormula([(Literal(0), Literal(1))], 2)
    config = SolverConfig(ode=ODEConfig(step_size=0.05, steps=64), batch_size=4, seed=2,
                          chunk_steps=64)
    stopped = []
    real = loop.drive_chunks

    def spy(state, *args, **kwargs):
        out = real(state, *args, **kwargs)
        stopped.append(out[0].done.cpu().numpy())
        return out

    monkeypatch.setattr(loop, "drive_chunks", spy)
    result = hybrid_search(formula, config, device="cpu")
    assert result.engine == "ode" and result.solved and result.steps == 64
    assert evaluate_cnf(dict(enumerate(map(bool, result.assignment))), formula)
    assert stopped[0][:, 0].any() and stopped[0][:, 1].any()  # both engines were done


def test_a_stoch_win_reads_out_the_stoch_chain():
    """An ODE step too small to solve: the stoch engine wins, and its first
    done chain's assignment satisfies the formula."""
    _, formula = normalize_cnf_variables(CNFFormula(
        [(Literal(0), Literal(1, True)), (Literal(1), Literal(2)), (Literal(0, True),
                                                                    Literal(2))], 3))
    config = SolverConfig(ode=ODEConfig(step_size=1e-9, steps=64), batch_size=4, seed=1,
                          chunk_steps=16)
    result = hybrid_search(formula, config, device="cpu")
    assert result.engine == "stoch" and result.solved and result.steps == 16
    assert evaluate_cnf(dict(enumerate(map(bool, result.assignment))), formula)
    assert set(result.engine_seconds) == {"ode", "stoch"}


def test_hybrid_state_is_not_a_bare_tuple():
    st = HybridState(torch.zeros(2), torch.zeros(2))
    assert type(st) is not tuple


def _assert_formula_arrays_equal(a, b):
    for f in dataclasses.fields(a):
        if f.name == "shard_plan":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", ["small.cnf", "easy.cnf", "hard.cnf"])
def test_compiled_arrays_equal_jax(data_dir, name):
    """One device: the JAX hybrid's compile_formula call (hybrid.py:74-79);
    a 1x2 mesh: compile_for_mesh for the ODE engine, plan included."""
    from odesat_tpu.parallel.mesh import make_mesh
    from odesat_tpu.parallel.sharded import compile_for_mesh as jcompile_for_mesh
    from types import SimpleNamespace

    path = os.path.join(data_dir, name)
    jformula = jnormalize(jparse(path))[1]
    formula = normalize_cnf_variables(parse_dimacs_file(path))[1]
    jconfig, config = JSC(), SolverConfig()
    jfa = jcompile(jformula, clause_pad=jconfig.clause_pad, var_pad=jconfig.var_pad,
                   window_sort=jconfig.window_sort)
    _assert_formula_arrays_equal(hybrid_arrays(formula, config), jfa)
    import jax

    jmesh = jcompile_for_mesh(jformula, jconfig, make_mesh(1, 2, devices=jax.devices()[:2]))
    mesh = hybrid_arrays(formula, config, SimpleNamespace(n_clause=2))
    _assert_formula_arrays_equal(mesh, jmesh)
    assert (mesh.shard_plan is None) == (jmesh.shard_plan is None)
    if mesh.shard_plan is not None:  # the JAX plan carried over, table for table
        from odesat_tpu_torch.interop import formula_arrays_from_numpy

        carried, own = formula_arrays_from_numpy(jmesh).shard_plan, mesh.shard_plan
        assert (carried.n_shards, carried.mp_local) == (own.n_shards, own.mp_local)
        for a, b in zip(carried.tables, own.tables):
            for key in ("lit_code", "occ_ptr", "occ_slot"):
                np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)


@pytest.mark.parametrize("name, args", [
    ("easy.cnf", ["-b", "16", "-n", "2000"]),
    ("hard.cnf", ["-b", "8", "-n", "64", "--chunk-steps", "16", "-s", "0.01",
                  "--no-preprocess"]),
])
def test_gloo_mesh_agrees_with_one_device(data_dir, tmp_path, capsys, name, args):
    """T=2 x S=2 on gloo against one device: the same Winner line and
    verdict; on hard.cnf the final ODE v (a snapshot each) within the f32
    tolerance and the ODE done flags equal."""
    base = ["hybrid", "-f", os.path.join(data_dir, name), *args, "--seed", "0",
            "--device", "cpu", "--checkpoint-every", "1"]
    mesh = ["--devices", "2", "--clause-shards", "2", "--dist-backend", "gloo"]
    one, two = str(tmp_path / "one.npz"), str(tmp_path / "two.npz")
    assert cli.main([*base, "--checkpoint", one]) == 0
    single = _lines(capsys.readouterr().out)
    assert cli.main([*base, "--checkpoint", two, *mesh]) == 0
    assert _lines(capsys.readouterr().out) == single
    if name == "hard.cnf":
        assert single == (("none", "64"), "false")
        with np.load(one) as a, np.load(two) as b:
            assert tuple(b["mesh_layout"]) == (2, 2) and b["rng_cpu"].shape[0] == 2
            np.testing.assert_allclose(b["ode_v"], a["ode_v"], **F32)
            np.testing.assert_array_equal(b["ode_done"], a["ode_done"])
            assert int(a["steps"]) == int(b["steps"]) == 64
    else:
        assert single[1] == "true"


def test_hybrid_resume_refuses_another_traj_width(data_dir, tmp_path, capsys):
    """A hybrid snapshot holds one stoch generator per trajectory row: a
    resume on another --devices count is refused (JAX :101-124)."""
    hard = os.path.join(data_dir, "hard.cnf")
    path = str(tmp_path / "h.npz")
    base = ["hybrid", "-f", hard, "-b", "8", "-n", "32", "--chunk-steps", "16", "-s", "0.01",
            "--seed", "3", "--no-preprocess", "--device", "cpu"]
    assert cli.main([*base, "--checkpoint", path, "--checkpoint-every", "1", "--devices", "2",
                     "--dist-backend", "gloo"]) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        cli.main([*base, "-n", "64", "--resume", path])
    assert e.value.code == 2
    assert "cannot resume this hybrid snapshot" in capsys.readouterr().err
