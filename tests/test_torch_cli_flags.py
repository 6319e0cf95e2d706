"""The JAX CLI's command lines parse under the port's CLI.

Every solver subcommand of the JAX CLI takes the flags of its
``_add_common`` (odesat_tpu/cli.py) and ignores those that do not apply:
``batch`` and ``inter`` never preprocess, ``stoch`` reads no ODE flag. The
port takes the same command lines, ``hybrid``'s, the snapshot and profiler
flags and the multi-host ``--pod-mesh``, ``--coordinator``,
``--num-processes`` and ``--process-id`` included, and parses them to the
same values; only the ``onehot`` strategy, which the port does not offer,
is left out here.
"""

import os

import pytest

torch = pytest.importorskip("torch")

from odesat_tpu import cli as jcli  # noqa: E402
from odesat_tpu_torch import cli  # noqa: E402
import tests.torch_parity  # noqa: E402,F401  (thread count)

TRUE = "Checking if solution vector satisfies formula: true"
FALSE = "Checking if solution vector satisfies formula: false"

# _add_common's flags that the port serves, with a value each
COMMON = ["-o", "out.txt", "--seed", "3", "--chunk-steps", "64", "--rigidity", "reference",
          "--dv-strategy", "gather", "--dtype", "float32", "--var-order", "bandwidth",
          "--matmul-dtype", "bfloat16", "--devices", "1", "--clause-shards", "1",
          "--shard-chunk", "off", "--log-every", "0", "--wall-clock-budget", "30",
          "--no-preprocess", "--checkpoint", "ck.npz", "--checkpoint-every", "2",
          "--resume", "old.npz", "--profile-dir", "prof", "--pod-mesh",
          "--coordinator", "10.0.0.1:4321", "--num-processes", "2", "--process-id", "1"]
OWN = {
    "solve": ["-t", "0.001", "-n", "100", "-s", "0.01", "-l", "0.05", "-r", "7",
              "--solve-batch", "4"],
    "batch": ["-t", "0.001", "-n", "100", "-s", "0.01", "-b", "8", "-l", "0.05",
              "--dt-mode", "shared"],
    "inter": ["-t", "0.001", "-n", "100", "-s", "0.01", "-b", "8", "-l", "0.05",
              "--dt-mode", "per-trajectory"],
    "stoch": ["-n", "100", "-r", "7", "-b", "4"],
    "hybrid": ["-t", "0.001", "-n", "100", "-s", "0.01", "-b", "8", "-l", "0.05", "-r", "7"],
}


@pytest.mark.parametrize("cmd", sorted(OWN))
def test_jax_command_lines_parse_under_the_port(cmd):
    """A command line the JAX CLI takes, with every served flag of
    ``_add_common`` and the subcommand's own, parses under the port to the
    same values."""
    argv = [cmd, "-f", "x.cnf", *COMMON, *OWN[cmd]]
    jargs = jcli._build_parser().parse_args(argv)
    targs = cli._build_parser().parse_args(argv)
    for dest, value in vars(jargs).items():
        if hasattr(targs, dest):
            assert getattr(targs, dest) == value, dest
    missing = sorted(d for d in vars(jargs) if not hasattr(targs, d))
    assert missing == []


@pytest.mark.parametrize("cmd, extra, verdict", [
    ("inter", ["-b", "8", "-n", "2000", "-s", "0.01", "--no-preprocess"], TRUE),
    ("batch", ["-b", "8", "-n", "2000", "-s", "0.01", "--no-preprocess"], TRUE),
    ("stoch", ["-b", "8", "-n", "2000", "--rigidity", "reference", "--dtype", "float64",
               "--dv-strategy", "segment_sum"], TRUE),
])
def test_flags_that_do_not_apply_are_ignored(data_dir, capsys, cmd, extra, verdict):
    """The accepted flags change nothing where they do not apply: batch and
    inter never preprocess, stoch reads no ODE flag."""
    rc = cli.main([cmd, "-f", os.path.join(data_dir, "small.cnf"), "--seed", "1",
                   "--device", "cpu", *extra])
    assert rc == 0
    assert verdict in capsys.readouterr().out
