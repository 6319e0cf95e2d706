"""The port's ``solve``, ``batch`` and ``gen`` subcommands on the CPU
against the JAX package's CLI: the same verdict lines and exit codes on
small.cnf, easy.cnf and hard.cnf, the same DIMACS from ``gen`` for the
same seed, the batch progress line, and the errors (exit 2) for a kernel
strategy that cannot take the run."""

import os
import re

import pytest

torch = pytest.importorskip("torch")

from odesat_tpu import cli as jcli  # noqa: E402
from odesat_tpu_torch import cli  # noqa: E402
import tests.torch_parity  # noqa: E402,F401  (thread count)

VERDICT = re.compile(r"^Checking if solution vector satisfies formula: (true|false)$", re.M)

# (subcommand, fixture, arguments): budgets the fixtures solve within on the
# CPU (hard.cnf is UNSAT and runs its budget to "false")
RUNS = [
    ("solve", "small", ["-s", "0.01", "-n", "2000", "--seed", "0"]),
    ("solve", "easy", ["-n", "4000", "--seed", "1"]),
    ("solve", "hard", ["-s", "0.01", "-n", "200", "--seed", "0"]),
    ("batch", "small", ["-b", "8", "-n", "1000", "-s", "0.01", "--seed", "2", "--chunk-steps", "128"]),
    ("batch", "easy", ["-b", "8", "-n", "4000", "-s", "0.01", "--seed", "1"]),
    ("batch", "hard", ["-b", "4", "-n", "200", "-s", "0.01", "--seed", "0", "--chunk-steps", "64"]),
]


def _verdicts(out):
    return VERDICT.findall(out)


@pytest.mark.parametrize("sub,name,args", RUNS, ids=[f"{s}-{n}" for s, n, _ in RUNS])
def test_verdicts_match_the_jax_cli(data_dir, capsys, tmp_path, sub, name, args):
    path = os.path.join(data_dir, f"{name}.cnf")
    out_j, out_t = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    rc_j = jcli.main([sub, "-f", path, "-o", out_j, *args])
    jout = capsys.readouterr().out
    rc_t = cli.main([sub, "-f", path, "-o", out_t, *args, "--device", "cpu"])
    tout = capsys.readouterr().out
    assert rc_t == rc_j == 0
    want = ["false"] if name == "hard" else ["true"]
    assert _verdicts(tout) == _verdicts(jout) == want
    # the same phases in the same order (the port adds its steps line)
    phases = [line for line in jout.splitlines() if line.endswith("...")]
    assert [line for line in tout.splitlines() if line.endswith("...")] == phases
    if sub == "solve":
        assert ("Preprocessing CNF formula..." in tout) and "Mapping values..." in tout
    with open(out_t, encoding="utf-8") as fh:
        lines = fh.read().strip().splitlines()
    assert lines and all(len(line.split()) == 2 for line in lines)


def test_solve_no_preprocess_and_micro_batch(data_dir, capsys):
    rc = cli.main(["solve", "-f", os.path.join(data_dir, "easy.cnf"), "-n", "4000", "-s", "0.01",
                   "--seed", "2", "--no-preprocess", "--solve-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Preprocessing" not in out and "/2 |" in out
    assert _verdicts(out) == ["true"]
    args = cli._build_parser().parse_args(["solve", "-f", "x.cnf"])
    assert args.solve_batch == 8 and args.ctv_ratio is None and args.device == "cuda"


def test_batch_progress_line(data_dir, capsys):
    rc = cli.main(["batch", "-f", os.path.join(data_dir, "small.cnf"), "-b", "4", "-n", "600",
                   "-s", "0.01", "--seed", "3", "--chunk-steps", "128", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "\rRunning batch:" in out and "trajectories converged" in out


@pytest.mark.parametrize(
    "extra",
    [["--planted", "--seed", "7"], ["-m", "50", "-k", "4", "--seed", "3"],
     ["--locality", "8", "--seed", "5"]],
    ids=["planted", "k4", "local"],
)
def test_gen_writes_the_jax_clis_dimacs(tmp_path, capsys, extra):
    pj, pt = str(tmp_path / "j.cnf"), str(tmp_path / "t.cnf")
    assert jcli.main(["gen", "-o", pj, "-n", "30", *extra]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["gen", "-o", pt, "-n", "30", *extra]) == 0
    tout = capsys.readouterr().out
    with open(pj, encoding="utf-8") as a, open(pt, encoding="utf-8") as b:
        assert a.read() == b.read()
    assert tout.replace(pt, "X") == jout.replace(pj, "X")


def test_gen_rejects_narrow_locality(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["gen", "-o", str(tmp_path / "x.cnf"), "-n", "50", "--locality", "2"])
    assert e.value.code == 2
    assert "locality" in capsys.readouterr().err


@pytest.mark.parametrize("sub", ["solve", "batch"])
def test_no_cuda_without_device_cpu_is_an_error(data_dir, capsys, monkeypatch, sub):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = ["-b", "2", "-n", "10"] if sub == "batch" else []
    with pytest.raises(SystemExit) as e:
        cli.main([sub, "-f", os.path.join(data_dir, "small.cnf"), *extra])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize(
    "sub,extra,why",
    [
        ("inter", ["-b", "2", "--dv-strategy", "stream", "--dtype", "float64"], "float64"),
        ("batch", ["-b", "2", "--dv-strategy", "stream", "--dt-mode", "shared"], "shared"),
        ("solve", ["--no-preprocess", "--dv-strategy", "pallas"], "unit-clause"),
        ("inter", ["-b", "2", "--dv-strategy", "stream"], "unit-clause"),
    ],
)
def test_kernel_strategy_that_cannot_run_exits_2(tmp_path, capsys, sub, extra, why):
    """A forced kernel strategy never falls back: what the kernel cannot
    take (unit clauses, float64, a batch-shared adaptive dt) is a library
    ValueError, which the CLI surfaces as exit 2."""
    path = tmp_path / "units.cnf"
    path.write_text("p cnf 3 3\n1 0\n-1 2 3 0\n2 -3 0\n")
    with pytest.raises(SystemExit) as e:
        cli.main([sub, "-f", str(path), "-n", "10", *extra, "--device", "cpu"])
    assert e.value.code == 2
    assert why in capsys.readouterr().err
