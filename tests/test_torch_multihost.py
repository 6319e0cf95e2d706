"""Multi-host jobs of the port (odesat_tpu_torch/parallel/multihost.py), on
the CPU with gloo: the counterpart of tests/test_multihost.py.

Two coordinated processes on this machine stand for two hosts. Each joins
the job through the ``TCPStore`` that process 0 hosts on the coordinator
(the coordinator form of ``initialize_distributed``), then starts its own
ranks (``parallel/launch.spawn`` with the pod), global ranks ``process_id
* L`` on. Every subprocess is bounded by ``TIMEOUT``.

* The CLI: two ``inter --pod-mesh`` processes print ``true``; process 0
  alone writes ``-o``, and its assignment and ``Steps run`` equal the
  one-process ``--devices 2`` run; without ``--seed`` both processes print
  the same assignment.
* Four scenarios, as in tests/multihost_worker.py: ``basic`` (T=2 across
  the processes, S=1, fixed), ``clause`` (two processes of two ranks, S=2;
  no clause group crosses a process), ``adaptive`` (``dt_mode='shared'``,
  whose batch max crosses the processes) and ``stoch`` (the clause-sharded
  stoch path). Each equals the one-process world of the same mesh bit for
  bit; ``basic`` is also held against the JAX package's one-process 2x1
  mesh from the same NumPy state, within rtol 2e-4 / atol 2e-5 (float32
  sums in another order: tests/test_torch_sharding.py's tolerance).
* Failures end in an error, never in a single-process run: an unreachable
  coordinator raises within its 5 s timeout, a lone process of a pair
  exits non-zero within ``--dist-timeout`` and prints no verdict, ``S``
  not dividing a process's ranks exits 2, half-given flags exit 2, and
  processes that ask for different meshes both fail. The mesh shape a pod
  gives the CLI's flags is checked on a stand-in pod.
"""

import contextlib
import io
import os
import pickle
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.models import ode as jode  # noqa: E402
from odesat_tpu.ops.shard_stream import compile_stream_sharded as jcompile_sharded  # noqa: E402
from odesat_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from odesat_tpu.parallel.sharded import (  # noqa: E402
    STATE_SPECS,
    dev_specs_for,
    make_sharded_chunk_runner as jsharded_runner,
)
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu_torch import cli  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy  # noqa: E402
from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded  # noqa: E402
from odesat_tpu_torch.parallel import launch, multihost, sharded  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from tests.test_torch_shard_stream import _mixed_width_formula  # noqa: E402
from tests.torch_parity import jax_state, numpy_state, port_formula  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = os.path.join(REPO, "tests", "data", "small.cnf")
TIMEOUT = 120  # every subprocess's communicate
F32 = dict(rtol=2e-4, atol=2e-5)
ZETA = 0.001
STEPS = 6
TRUE = "Checking if solution vector satisfies formula: true"

# What each process of a scenario's pod runs (``python -c``, so that its
# spawned ranks re-import no main module): join the job, start this
# process's ranks on the pickled (fn, args), pickle its first rank's value.
DRIVER = """
import pickle, sys
from odesat_tpu_torch.parallel import launch
from odesat_tpu_torch.parallel.multihost import initialize_distributed
coord, P, pid, L, T, S, payload, out = sys.argv[1:]
pod = initialize_distributed("gloo", "cpu", coordinator=coord, num_processes=int(P),
                             process_id=int(pid), local_world_size=int(L), timeout_s=60)
with open(payload, "rb") as fh:
    fn, args = pickle.load(fh)
value = launch.spawn(fn, int(T), int(S), "gloo", "cpu", timeout_s=90, args=args,
                     collective_timeout_s=60, pod=pod)
with open(out, "wb") as fh:
    pickle.dump(value, fh)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(local_world_size=None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    if local_world_size is not None:
        env["LOCAL_WORLD_SIZE"] = str(local_world_size)
    return env


def _communicate(procs) -> list:
    """(returncode, output) of each process, each bounded by TIMEOUT; a
    process that outlives it fails the test after every one is killed."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
            q.communicate()
        pytest.fail("a process of the pod outlived its timeout")
    return outs


def _cli_pair(*argv, local_world_size=None):
    """Two processes of a job running ``python -m odesat_tpu_torch *argv``
    (with the coordinator flags added); their (returncode, output)."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "odesat_tpu_torch", *argv, "--device", "cpu",
         "--dist-backend", "gloo", "--coordinator", coord, "--num-processes", "2",
         "--process-id", str(i), "--dist-timeout", "60"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=_env(local_world_size)) for i in range(2)]
    return _communicate(procs)


def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    return rc, out.getvalue()


def _steps_line(text: str) -> str:
    return next(line for line in text.splitlines() if line.startswith("Steps run"))\
        .rsplit("|", 1)[0]  # the wall time differs


def test_cli_pod_mesh_two_processes(tmp_path):
    """``inter --pod-mesh`` over two processes of one rank each: both print
    true; process 0 alone writes -o, and the assignment and steps equal the
    one-process --devices 2 run of the same command."""
    out_pod, out_one = tmp_path / "pod.txt", tmp_path / "one.txt"
    argv = ["inter", "-f", SMALL, "-b", "8", "-n", "256", "-s", "0.01", "--seed", "0",
            "--chunk-steps", "64"]
    outs = _cli_pair(*argv, "--pod-mesh", "-o", str(out_pod))
    for i, (rc, text) in enumerate(outs):
        assert rc == 0, f"process {i}:\n{text[-3000:]}"
        assert TRUE in text, text[-2000:]
    rc, text = _cli(*argv, "--devices", "2", "--device", "cpu", "--dist-backend", "gloo",
                    "-o", str(out_one))
    assert rc == 0
    assert out_pod.read_text() == out_one.read_text()
    assert {_steps_line(t) for _, t in outs} == {_steps_line(text)}


def test_cli_pod_without_seed_agrees_on_process_0s_draw():
    """No --seed: process 0 draws one and it reaches process 1 through the
    store, so both print the same assignment."""
    outs = _cli_pair("inter", "-f", SMALL, "-b", "4", "-n", "64", "-s", "0.01",
                     "--chunk-steps", "64", "--pod-mesh")
    assignments = []
    for rc, text in outs:
        assert rc == 0, text[-3000:]
        assignments.append(text.split("Variable assignments:", 1)[1])
    assert assignments[0] == assignments[1]


def _scenario(name):
    """(fn, args, (T, S), L) of a scenario: the mesh, and a process's ranks."""
    normalized = _mixed_width_formula(seed=23, counts=(60, 260, 60))
    if name == "stoch":
        fa, _ = compile_stream_sharded(port_formula(normalized), 2)
        return sharded.run_stoch_clause, (fa, 4, 8, 13, "float32", 8), (2, 2), 2
    if name == "clause":
        jfa, _ = jcompile_sharded(normalized, 2)
        case = (formula_arrays_from_numpy(jfa), ZETA,
                ODEConfig(step_size=0.01, dv_strategy="stream"), STEPS, numpy_state(jfa, 8, 3))
        return launch.run_all, ([(launch.where, ()), (sharded.run_ode_cases, ([case],))],), \
            (2, 2), 2
    jfa = jcompile(normalized)
    ode = ODEConfig(step_size=0.01) if name == "basic" else \
        ODEConfig(tolerance=1e-3, dt_mode="shared")
    case = (formula_arrays_from_numpy(jfa), ZETA, ode, STEPS, numpy_state(jfa, 8, 3))
    return sharded.run_ode_cases, ([case],), (2, 1), 1


def _pod_run(tmp_path, fn, args, shape, L):
    """The values of a 2-process pod's first ranks, beside the one-process
    world of the same mesh (run here while the pod runs)."""
    payload = tmp_path / "payload.pkl"
    payload.write_bytes(pickle.dumps((fn, args)))
    coord = f"127.0.0.1:{_free_port()}"
    outs = [tmp_path / f"out{i}.pkl" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", DRIVER, coord, "2", str(i), str(L), *map(str, shape),
         str(payload), str(outs[i])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=_env())
        for i in range(2)]
    try:
        one = launch.spawn(fn, *shape, "gloo", "cpu", timeout_s=TIMEOUT, args=args)
    finally:
        results = _communicate(procs)
    for i, (rc, text) in enumerate(results):
        assert rc == 0, f"process {i}:\n{text[-4000:]}"
    return [pickle.loads(out.read_bytes()) for out in outs], one


def _assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def basic_run(tmp_path_factory):
    fn, args, shape, L = _scenario("basic")
    return _pod_run(tmp_path_factory.mktemp("basic"), fn, args, shape, L), args


@pytest.mark.parametrize("name", ["basic", "clause", "adaptive", "stoch"])
def test_two_process_pod_equals_one_process_mesh(name, tmp_path, basic_run):
    """Each process's result equals the one-process world of the same
    global mesh, bit for bit."""
    if name == "basic":
        (pods, one), _ = basic_run
    else:
        fn, args, shape, L = _scenario(name)
        pods, one = _pod_run(tmp_path, fn, args, shape, L)
    if name == "clause":
        for layout in (pods[0][0], pods[1][0]):
            # every clause group (a trajectory row) lies inside one process,
            # and the rows lie in different processes
            rows = {t: {ppid for tt, _, ppid in layout if tt == t} for t, _, _ in layout}
            assert all(len(parents) == 1 for parents in rows.values()), layout
            assert len(set.union(*rows.values())) == 2, layout
        pods, one = [p[1] for p in pods], one[1]
    if name != "stoch":
        # the ODE cases end in the v of every clause rank of the returning
        # rank's trajectory row: a row of its own in each process
        for value in pods:
            for copies in value[0][5]:
                np.testing.assert_array_equal(copies, value[0][5][0])
        pods, one = [[case[:5] for case in p] for p in pods], [case[:5] for case in one]
    for value in pods:
        _assert_same(value, one)


def test_pod_basic_matches_the_jax_mesh(basic_run):
    """The two-process T=2 run against the JAX package's one-process 2x1
    mesh from the same NumPy state (its scan path, segment_sum)."""
    (pods, _), args = basic_run
    fa_port, zeta, _, steps, arrays = args[0][0]
    jfa = jcompile(_mixed_width_formula(seed=23, counts=(60, 260, 60)))
    mesh = jmake_mesh(2, 1, jax.devices()[:2])
    state = jax_state(arrays)
    dev = jode.formula_device(jfa)
    put = lambda tree, specs: jax.tree.map(  # noqa: E731
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)
    run = jsharded_runner(jfa, zeta, JODE(step_size=0.01, dv_strategy="segment_sum"), steps,
                          mesh)
    ref = run(put(state, STATE_SPECS), put(dev, dev_specs_for(dev)))
    out = pods[1][0]  # process 1's copy of the global state
    for name, a, b in zip(("v", "xs", "xl"), out[:3], ref[:3]):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **F32)
    np.testing.assert_array_equal(out[4], np.asarray(ref[4]))


def test_unreachable_coordinator_raises_within_its_timeout():
    """Nobody listens on the port: the join raises within its 5 s timeout
    and joins nothing."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not answer within 5"):
        multihost.initialize_distributed("gloo", "cpu", coordinator=f"127.0.0.1:{_free_port()}",
                                         num_processes=2, process_id=1, local_world_size=1,
                                         timeout_s=5)
    assert time.monotonic() - t0 < 10
    assert multihost.current_pod() is None


def test_a_lone_process_exits_non_zero_and_prints_no_verdict():
    """Process 1 with no process 0 (nobody hosts the store), and process 0
    with no process 1 (its peer never joins): each exits non-zero within
    its --dist-timeout of 5 s, with an error and no verdict."""
    argv = ["inter", "-f", SMALL, "-b", "4", "-n", "64", "-s", "0.01", "--seed", "0",
            "--pod-mesh", "--device", "cpu", "--dist-backend", "gloo", "--num-processes", "2",
            "--dist-timeout", "5"]
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "odesat_tpu_torch", *argv, "--process-id", str(i),
         "--coordinator", f"127.0.0.1:{_free_port()}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=_env())
        for i in (1, 0)]
    for rc, text in _communicate(procs):
        assert rc != 0, text[-2000:]
        assert "error:" in text, text[-2000:]
        assert "Checking if solution vector" not in text
    assert time.monotonic() - t0 < 60


def test_clause_shards_must_divide_a_processes_ranks(monkeypatch, capsys):
    """--pod-mesh over a process of 3 ranks cannot hold clause groups of 2
    inside a process: exit 2 with make_pod_mesh's message, before any rank
    starts; a spawn with such a pod raises the same."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(SystemExit) as e:
        _cli("inter", "-f", SMALL, "-b", "6", "-n", "10", "--seed", "0", "--pod-mesh",
             "--clause-shards", "2", "--device", "cpu", "--dist-backend", "gloo")
    assert e.value.code == 2
    assert "3 ranks a process not divisible by clause=2" in capsys.readouterr().err
    pod = multihost.Pod("127.0.0.1:1", 2, 0, 3, store=None)
    with pytest.raises(ValueError, match="not divisible by clause=2"):
        launch.spawn(launch.probe, 3, 2, "gloo", "cpu", pod=pod)


@pytest.mark.parametrize("flags, match", [
    (("--coordinator", "127.0.0.1:1"), "without num_processes, process_id"),
    (("--num-processes", "2", "--process-id", "0"), "without coordinator"),
    (("--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id", "2"),
     r"process_id 2 outside \[0, 2\)"),
    (("--coordinator", "localhost", "--num-processes", "2", "--process-id", "0"),
     "is not HOST:PORT"),
])
def test_half_given_or_out_of_range_flags_exit_2(capsys, flags, match):
    with pytest.raises(SystemExit) as e:
        _cli("inter", "-f", SMALL, "-b", "4", "-n", "10", "--device", "cpu", "--dist-backend",
             "gloo", *flags)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert re.search(match, err), err
    assert multihost.current_pod() is None


@pytest.mark.parametrize("pod, flags, shape", [
    ((2, 2), ("--pod-mesh", "--clause-shards", "2"), (2, 2)),
    ((2, 2), ("--pod-mesh",), (4, 1)),
    ((2, 2), ("--devices", "2", "--clause-shards", "2"), (2, 2)),
    ((2, 2), ("--devices", "3"), None),  # 3 ranks in a job of 4
    ((2, 3), ("--pod-mesh", "--clause-shards", "2"), None),  # a group across processes
    (None, ("--pod-mesh", "--clause-shards", "2"), (2, 2)),  # LOCAL_WORLD_SIZE=4
])
def test_the_mesh_shape_of_a_pod(monkeypatch, capsys, pod, flags, shape):
    """The mesh the CLI runs in a pod of P processes of L ranks (a stand-in
    pod: no store is reached before the spawn): --pod-mesh spans P*L ranks,
    --devices must make up the job's ranks, S must divide L; else exit 2."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    if pod is not None:
        P, L = pod
        monkeypatch.setattr(multihost, "_pod", multihost.Pod("127.0.0.1:1", P, 0, L, store=None))
    args = cli._build_parser().parse_args(["inter", "-f", SMALL, "-b", "8", "--device", "cpu",
                                           "--dist-backend", "gloo", *flags])
    if shape is None:
        with pytest.raises(SystemExit) as e:
            cli._mesh_shape(args)
        assert e.value.code == 2
        assert "error:" in capsys.readouterr().err
    else:
        assert cli._mesh_shape(args) == shape


def test_processes_that_disagree_on_the_mesh_both_fail():
    """Process 1 asks for another mesh than process 0 (4x1 against 2x2, two
    ranks a process): it exits 2 on process 0's shape, and process 0, whose
    peer's ranks never come, exits non-zero within its --dist-timeout;
    neither prints a verdict."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "odesat_tpu_torch", "inter", "-f", SMALL, "-b", "4", "-n", "64",
         "-s", "0.01", "--seed", "0", "--device", "cpu", "--dist-backend", "gloo",
         "--coordinator", coord, "--num-processes", "2", "--process-id", str(i),
         "--dist-timeout", "5", "--pod-mesh", *(("--clause-shards", "2") if i == 0 else ())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=_env(local_world_size=2)) for i in range(2)]
    (rc0, out0), (rc1, out1) = _communicate(procs)
    assert rc1 == 2, out1[-2000:]
    assert "process 0 runs a 2x2 mesh, this process 4x1" in out1, out1[-2000:]
    assert rc0 != 0, out0[-2000:]
    for out in (out0, out1):
        assert "Checking if solution vector" not in out
