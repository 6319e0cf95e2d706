"""The port's CLI, ``python -m odesat_tpu_torch inter``, on the CPU: the
verdict line, exit codes, and no silent move to the CPU."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from odesat_tpu_torch import cli  # noqa: E402
import tests.torch_parity  # noqa: E402,F401  (thread count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUE = "Checking if solution vector satisfies formula: true"
FALSE = "Checking if solution vector satisfies formula: false"


def test_module_entry_point_solves_small(data_dir):
    cmd = [sys.executable, "-m", "odesat_tpu_torch", "inter", "-f",
           os.path.join(data_dir, "small.cnf"), "-b", "8", "-n", "2000", "-s", "0.01",
           "--seed", "0", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert TRUE in proc.stdout
    assert "dv_strategy auto -> gather on cpu" in proc.stderr


@pytest.mark.parametrize(
    "extra",
    [
        [],
        ["--rigidity", "reference", "--dv-strategy", "segment_sum"],
        ["--dv-strategy", "fused", "--matmul-dtype", "bfloat16"],
        ["--dtype", "float64", "--var-order", "bandwidth"],
    ],
)
def test_inter_small_in_process(data_dir, capsys, tmp_path, extra):
    out = tmp_path / "out.txt"
    rc = cli.main(["inter", "-f", os.path.join(data_dir, "small.cnf"), "-b", "8", "-n", "2000",
                   "-s", "0.01", "--seed", "1", "--chunk-steps", "128", "--device", "cpu",
                   "-o", str(out), *extra])
    assert rc == 0
    assert TRUE in capsys.readouterr().out
    lines = out.read_text().strip().splitlines()
    assert lines and all(len(line.split()) == 2 for line in lines)


def test_inter_easy_adaptive_shared_dt(data_dir, capsys):
    rc = cli.main(["inter", "-f", os.path.join(data_dir, "easy.cnf"), "-b", "4", "-n", "4000",
                   "--seed", "1", "--dt-mode", "shared", "--device", "cpu"])
    assert rc == 0
    assert TRUE in capsys.readouterr().out


def test_inter_hard_runs_its_budget_to_false(data_dir, capsys):
    rc = cli.main(["inter", "-f", os.path.join(data_dir, "hard.cnf"), "-b", "4", "-n", "300",
                   "-s", "0.01", "--seed", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert FALSE in out
    assert "Steps run: 300 |" in out


def test_missing_file_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["inter", "-f", "/nonexistent.cnf", "-b", "2", "--device", "cpu"])
    assert e.value.code == 2
    assert "input file not found" in capsys.readouterr().err


def test_library_value_error_exits_2(data_dir, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["inter", "-f", os.path.join(data_dir, "small.cnf"), "-b", "2", "-n", "10",
                  "--dv-strategy", "fused", "--dtype", "float64", "--device", "cpu"])
    assert e.value.code == 2
    assert "float64" in capsys.readouterr().err


@pytest.mark.parametrize("sub", ["solve", "stoch", "batch", "hybrid", "gen"])
def test_unported_subcommands_exit_2(sub, capsys):
    """Every subcommand is ported now: each reaches its own input check."""
    with pytest.raises(SystemExit) as e:
        if sub == "gen":  # no input file; a missing -n is argparse's exit 2
            cli.main([sub, "-o", "x.cnf"])
        else:  # ported since: each reaches the file check
            extra = ["-b", "2", "-n", "10"] if sub == "batch" else []
            cli.main([sub, "-f", "x.cnf", *extra, "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert ("required: -n" in err) if sub == "gen" else ("input file not found" in err)


def test_no_cuda_without_device_cpu_is_an_error(data_dir, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["inter", "-f", os.path.join(data_dir, "small.cnf"), "-b", "2"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
