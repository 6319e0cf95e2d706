"""The port's state donation (``odesat_tpu_torch/ops/device_loop.py`` states
the contract) on the CPU.

* Every entry point gives the results it gives unwrapped, and the JAX
  package's, when each donating chunk runner and each multi-chunk dispatch
  consumes its input as a donated buffer may be: the runners are wrapped
  here (monkeypatched, not a switch of the package) to fill their input
  with NaN (floats), -1 (integers) or True (bools) after computing, where
  it shares no memory with their result. ``solve_exact`` (its one-dispatch
  path through B1's plain version and its host-paced path over the twin),
  ``simulate_batch`` (with a harvest, with a checkpoint cadence, and over
  the multi-chunk dispatch), the stoch ``search`` (B3/B4's plain version
  and the twin) and ``hybrid_search``.
* The clause mesh's runners (B6, B5, B9, B8), which tile and run in their
  input's own storage: each returns its input's storage at a full and a
  ragged batch, and a second call of the shape runs on the buffers it
  holds and leaves a held result as it was; at S=2 (a gloo world)
  ``simulate_batch`` through B6 and B5, a resume, the stoch ``search``
  through B9 and B8 and ``hybrid_search`` give with the runners run on a
  copy and their inputs poisoned (``tests/donation_worker.py``) what they
  give as they run, and JAX's clause mesh's results.
* The held-result rule (``device_loop.StateBuffers``) and the scan chunk's
  choice of buffers (``ScanChunk.captured``) on CPU tensors: a call from
  the result it returned runs in place with no copy and no new capture; a
  result the caller holds is never written by a call from another state.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.cnf import parse_dimacs_file as jparse  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu.utils.config import SolverConfig as JSC  # noqa: E402
from odesat_tpu_torch.cnf import normalize_cnf_variables, parse_dimacs_file  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy, state_from_numpy  # noqa: E402
from odesat_tpu_torch.models import hybrid as thybrid  # noqa: E402
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.models import stoch as tstoch  # noqa: E402
from odesat_tpu_torch.ops import device_loop, scan_chunk  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
from odesat_tpu_torch.utils.tts import solve_exact  # noqa: E402
from tests.donation_worker import consume_clause_runners, poison  # noqa: E402
from tests.torch_parity import jax_state, numpy_state, port_formula  # noqa: E402


def consuming(monkeypatch):
    """Make every chunk runner built with ``donate`` (the default) and every
    multi-chunk dispatch consume its input, and every clause-mesh runner
    run on a copy and poison its input (``tests/donation_worker.py``), for
    as long as ``monkeypatch``'s context lasts. Returns the count of fields
    filled, so that a case can show that its path consumed something."""
    filled = {"n": 0}
    consume_clause_runners(monkeypatch.setattr, filled)

    def chunk_runners(build):
        def make(*a, **k):
            chunk = build(*a, **k)
            if chunk.donate:  # JAX's donate=False runners keep their input
                fn = chunk.fn

                def run(state, *args):
                    out = fn(state, *args)
                    filled["n"] += poison(state, out)
                    return out

                chunk.fn = run
            return chunk

        return make

    def dispatches(build):
        def make(*a, **k):
            multi = build(*a, **k)

            def run(state, *args):
                out, steps = multi(state, *args)
                filled["n"] += poison(state, out)
                return out, steps

            return run

        return make

    monkeypatch.setattr(tode, "make_chunk_runner", chunk_runners(tode.make_chunk_runner))
    monkeypatch.setattr(tstoch, "make_stoch_chunk_runner",
                        chunk_runners(tstoch.make_stoch_chunk_runner))
    monkeypatch.setattr(tode, "make_multi_chunk_runner", dispatches(tode.make_multi_chunk_runner))
    monkeypatch.setattr(tstoch, "make_multi_stoch_runner",
                        dispatches(tstoch.make_multi_stoch_runner))
    return filled


def _jfa(data_dir, name, dtype):
    return jcompile(jnormalize(jparse(os.path.join(data_dir, name)))[1], dtype=dtype)


def _normalized(data_dir, name):
    return normalize_cnf_variables(parse_dimacs_file(os.path.join(data_dir, name)))[1]


def _same_start(monkeypatch, arrays):
    """Both packages' ``init_state`` hand out ``arrays`` (the port a copy
    each time: a consumed state must not reach the NumPy arrays)."""
    from odesat_tpu.models import ode as jode

    monkeypatch.setattr(jode, "init_state", lambda *a, **k: jax_state(arrays))
    monkeypatch.setattr(tode, "init_state", lambda *a, **k: state_from_numpy(
        *(a.copy() for a in arrays), device="cpu"))


# ---------------------------------------------------------- solve_exact

EXACT = {
    # B1's plain version: the one-dispatch path, JAX's own one-dispatch
    # path through the fused kernel in interpret mode
    "fused-one-dispatch": (np.float32, dict(step_size=0.05, dv_strategy="fused")),
    # the twin in float64: the host-paced path of both packages
    "gather-host-paced": (np.float64, dict(step_size=0.05, dtype="float64")),
}


@pytest.mark.parametrize("chunk", [64, 48])
@pytest.mark.parametrize("case", sorted(EXACT))
def test_solve_exact_with_consumed_inputs_equals_unwrapped_and_jax(data_dir, monkeypatch, case,
                                                                   chunk):
    from odesat_tpu.utils.tts import solve_exact as jsolve_exact

    dtype, kw = EXACT[case]
    jfa = _jfa(data_dir, "easy.cnf", dtype)
    fa = formula_arrays_from_numpy(jfa)
    _same_start(monkeypatch, numpy_state(jfa, 8, seed=3, dtype=dtype))
    want = jsolve_exact(jfa, JODE(**kw), 8, None, chunk, 1024, readout=True)
    plain = solve_exact(fa, ODEConfig(**kw), 8, None, chunk, 1024, readout=True, device="cpu")
    with monkeypatch.context() as m:
        filled = consuming(m)
        got = solve_exact(fa, ODEConfig(**kw), 8, None, chunk, 1024, readout=True,
                          device="cpu")
    assert want.solved and plain.solved and got.solved
    for res in (plain, got):
        assert (res.steps, res.solved_index, res.chunks) == (want.steps, want.solved_index,
                                                             want.chunks)
        np.testing.assert_array_equal(res.assignment, np.asarray(want.assignment))
    # the one-dispatch path consumed its dispatches' inputs; the host-paced
    # path's runners are JAX's donate=False ones and consume nothing
    assert (filled["n"] > 0) == (case == "fused-one-dispatch")


# ---------------------------------------------------------- simulate_batch

def _simulate_configs(pkg, how, path):
    ode = dict(step_size=0.01, steps=4096, dtype="float64")
    kw = dict(batch_size=8, seed=0, chunk_steps=16)  # solves after 11 chunks
    if how == "checkpoints":
        kw.update(checkpoint_path=path, checkpoint_every_chunks=2)
    return JSC(ode=JODE(**ode), **kw) if pkg == "jax" else SolverConfig(ode=ODEConfig(**ode),
                                                                        **kw)


@pytest.mark.parametrize("how", ["harvest", "checkpoints", "dispatch"])
def test_simulate_batch_with_consumed_inputs_equals_unwrapped_and_jax(data_dir, monkeypatch,
                                                                      tmp_path, how):
    """easy.cnf, B=8, float64 fixed dt through the twin, from one NumPy
    state: with a harvest between chunks, with a snapshot every two chunks
    (the file's state too), and over the multi-chunk dispatch."""
    from odesat_tpu.models.ode import simulate_batch as jsimulate

    jfa = _jfa(data_dir, "easy.cnf", np.float64)
    fa = formula_arrays_from_numpy(jfa)
    _same_start(monkeypatch, numpy_state(jfa, 8, seed=5, dtype=np.float64))

    def harvest(st, done):  # reads the chunk's result before the next chunk takes it
        if not done.any():
            return None
        return (st.v[int(np.flatnonzero(done)[0]), : fa.n_vars] > 0).cpu().numpy()

    kw = {"harvest": harvest} if how == "harvest" else {}
    want = jsimulate(jfa, _simulate_configs("jax", how, str(tmp_path / "jax.npz")),
                     **({"harvest": lambda st, done: bool(done.any())} if kw else {}))
    plain = tode.simulate_batch(fa, _simulate_configs("torch", how, str(tmp_path / "plain.npz")),
                                device="cpu", **kw)
    with monkeypatch.context() as m:
        filled = consuming(m)
        got = tode.simulate_batch(fa, _simulate_configs("torch", how, str(tmp_path / "got.npz")),
                                  device="cpu", **kw)
    assert filled["n"] > 0 and want.solved_index is not None
    for res in (plain, got):
        assert (res.steps, res.solved_index) == (want.steps, want.solved_index)
        np.testing.assert_array_equal(res.done, np.asarray(want.done))
        np.testing.assert_array_equal(res.assignment, np.asarray(want.assignment))
    if how == "harvest":
        np.testing.assert_array_equal(got.harvested, plain.harvested)
        np.testing.assert_array_equal(got.harvested, np.asarray(want.assignment)[want.solved_index])
    if how == "checkpoints":
        files = [np.load(tmp_path / f"{n}.npz") for n in ("jax", "plain", "got")]
        assert int(files[0]["steps"]) == int(files[1]["steps"]) == int(files[2]["steps"]) > 0
        for name in ("v", "xs", "xl", "dt", "done"):
            key = f"field_{name}"
            np.testing.assert_array_equal(files[2][key], files[1][key], err_msg=name)
            np.testing.assert_allclose(files[2][key], files[0][key], rtol=1e-12, atol=1e-12,
                                       err_msg=name)


# ---------------------------------------------------------- stoch search, hybrid

@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("name, steps", [("small.cnf", 4000), ("hard.cnf", 300)])
def test_stoch_search_with_consumed_inputs_equals_unwrapped(data_dir, monkeypatch, fused, name,
                                                            steps):
    """B3/B4's plain version ("on") and the twin ("off"): the same chains
    with consumed inputs as without; small.cnf solves and hard.cnf runs its
    whole budget unsolved, as JAX's search does (its random streams are
    its own, so only these verdicts compare)."""
    from odesat_tpu.models.stoch import search as jsearch

    formula = _normalized(data_dir, name)
    config = SolverConfig(ode=ODEConfig(steps=steps), batch_size=8, seed=1, chunk_steps=32)
    plain = tstoch.search(formula, config, device="cpu", fused=fused)
    with monkeypatch.context() as m:
        filled = consuming(m)
        got = tstoch.search(formula, config, device="cpu", fused=fused)
    assert filled["n"] > 0
    assert (got.steps, got.solved_index) == (plain.steps, plain.solved_index)
    np.testing.assert_array_equal(got.assignment, plain.assignment)
    np.testing.assert_array_equal(got.done, plain.done)
    want = jsearch(jnormalize(jparse(os.path.join(data_dir, name)))[1],
                   JSC(ode=JODE(steps=steps), batch_size=8, seed=1, chunk_steps=32))
    assert (got.solved_index is None) == (want.solved_index is None) == (name == "hard.cnf")
    if name == "hard.cnf":
        assert got.steps == want.steps == steps


HYBRID = [
    ("small.cnf", dict(ode=dict(steps=2000), batch_size=16, seed=0)),
    ("hard.cnf", dict(ode=dict(steps=100, step_size=0.01), batch_size=8, seed=0,
                      chunk_steps=16)),
]


@pytest.mark.parametrize("name, kw", HYBRID, ids=[c[0] for c in HYBRID])
def test_hybrid_with_consumed_inputs_equals_unwrapped_and_jax(data_dir, monkeypatch, name, kw):
    """The CLI's cases of tests/test_torch_hybrid.py: the winner, steps and
    readout with consumed inputs as without, and the JAX hybrid's winner,
    steps and verdict."""
    from odesat_tpu.models.hybrid import hybrid_search as jhybrid

    def config(pkg):
        ode = (JODE if pkg == "jax" else ODEConfig)(**kw["ode"])
        rest = {k: v for k, v in kw.items() if k != "ode"}
        return (JSC if pkg == "jax" else SolverConfig)(ode=ode, **rest)

    formula = _normalized(data_dir, name)
    plain = thybrid.hybrid_search(formula, config("torch"), device="cpu")
    with monkeypatch.context() as m:
        filled = consuming(m)
        got = thybrid.hybrid_search(formula, config("torch"), device="cpu")
    assert filled["n"] > 0
    assert (got.engine, got.steps, got.solved) == (plain.engine, plain.steps, plain.solved)
    np.testing.assert_array_equal(got.assignment, plain.assignment)
    want = jhybrid(jnormalize(jparse(os.path.join(data_dir, name)))[1], config("jax"))
    assert (got.engine, got.steps, got.solved) == (want.engine, want.steps, want.solved)


# ---------------------------------------------------------- the held-result rule

def _state(seed, B=4, N=6):
    g = torch.Generator().manual_seed(seed)
    return tode.ODEState(torch.rand(B, N, generator=g), torch.rand(B, 3, generator=g),
                         torch.rand(B, 3, generator=g), torch.full((B,), 0.01),
                         torch.zeros(B, dtype=torch.bool))


def test_state_buffers_are_free_only_when_no_lent_view_lives():
    buf = device_loop.StateBuffers(_state(0))
    assert buf.free()
    lent = buf.lend()
    assert not buf.free() and buf.holds(lent) and not buf.holds(_state(0))
    row = lent.v[1]  # a view of a view holds the memory too
    del lent
    assert not buf.free()
    del row
    assert buf.free()


def test_state_buffers_load_copies_only_from_another_state():
    buf = device_loop.StateBuffers(_state(0))
    src = _state(1)
    before = device_loop.loads
    buf.load(src)
    lent = buf.lend()
    buf.load(lent)  # the state it holds: nothing to copy
    assert device_loop.loads == before + 1
    for a, b in zip(lent, src):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


class _Chunk(scan_chunk.ScanChunk):
    """The scan chunk's choice of buffers on CPU tensors: a "capture" is a
    buffer set with no graph, and a "replay" adds one to v in place."""

    def _capture(self, state, dev):
        scan_chunk.captures += 1
        return scan_chunk.Captured(device_loop.StateBuffers(state), (), dev)

    def call(self, state):
        cap = self.captured(state, (), self.donate)
        cap.buffers.load(state)
        cap.buffers.tensors.v.add_(1.0)
        return cap.buffers.lend()


@pytest.mark.parametrize("donate", [True, False])
def test_a_held_result_stays_and_a_result_passed_back_runs_in_place(donate):
    chunk = _Chunk(lambda st, dev: st, 4, "cpu", donate=donate)
    s0, s1 = _state(0), _state(1)
    v0, v1 = s0.v.clone(), s1.v.clone()
    captures, loads = scan_chunk.captures, device_loop.loads
    r0 = chunk.call(s0)
    r1 = chunk.call(s1)  # r0 held: a second buffer set, r0 untouched
    assert torch.equal(r0.v, v0 + 1) and torch.equal(r1.v, v1 + 1)
    assert torch.equal(s0.v, v0) and torch.equal(s1.v, v1)
    assert scan_chunk.captures == captures + 2 and device_loop.loads == loads + 2
    r2 = chunk.call(r1)
    assert torch.equal(r0.v, v0 + 1) and torch.equal(r2.v, v1 + 2)
    if donate:  # in place on r1's buffers: consumed, no copy, no capture
        assert r2.v.data_ptr() == r1.v.data_ptr() and torch.equal(r1.v, v1 + 2)
        assert (scan_chunk.captures, device_loop.loads) == (captures + 2, loads + 2)
    else:  # r1 kept: a third buffer set, r1 copied in
        assert r2.v.data_ptr() != r1.v.data_ptr() and torch.equal(r1.v, v1 + 1)
        assert (scan_chunk.captures, device_loop.loads) == (captures + 3, loads + 3)
    del r0, r1
    r3 = chunk.call(s0)  # a freed set is reused: no capture
    assert torch.equal(r3.v, v0 + 1)
    assert scan_chunk.captures == captures + (2 if donate else 3)
    assert len(chunk.graphs) == (2 if donate else 3)


# ---------------------------------------------------------- the clause mesh
#
# B6, B5, B9 and B8's runners work in their input's own storage and hold
# their buffers for each batch shape; with the wrappers of
# tests/donation_worker.py each runs on a copy and poisons its input
# instead. Both must give what JAX's clause mesh gives.

CLAUSE_RUNNERS = ("B6 fixed", "B6 adaptive", "B5", "B9", "B8")


def _clause_runner(name, fa, steps=6):
    from odesat_tpu_torch.ops import shard_chunk as sch
    from odesat_tpu_torch.ops import shard_stream as ss
    from odesat_tpu_torch.parallel import sharded

    if name in ("B9", "B8"):
        return sharded.make_clause_stoch_runner(fa, steps, "cpu",
                                                torch.Generator().manual_seed(3), None,
                                                "float32", "auto" if name == "B9" else "off")
    ode = ODEConfig(step_size=0.02) if name != "B6 adaptive" else ODEConfig(tolerance=1e-3)
    if name == "B5":
        return ss.make_single_device_runner(fa, 0.05, ode, steps, "cpu")
    return sch.make_shard_chunk(fa, 0.05, ode, steps, None, "cpu")


def _clause_state(name, fa, B, seed):
    from odesat_tpu_torch.models.stoch import StochState

    rng = np.random.default_rng(seed)
    if name in ("B9", "B8"):
        return StochState(torch.as_tensor(rng.random((B, fa.n_vars_padded)) < 0.5),
                          torch.ones((B, fa.n_clauses_padded), dtype=torch.int32),
                          torch.zeros(B, dtype=torch.bool))
    v = rng.uniform(-1, 1, (B, fa.n_vars_padded)).astype(np.float32)
    xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
    return state_from_numpy(v, xs, np.ones_like(xs), np.full(B, 0.01, np.float32),
                            np.arange(B) % 5 == 0, device="cpu")


def _held_tensors(obj, out):
    """Every tensor a runner holds (``run.held``), walked through its
    containers and objects."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _held_tensors(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _held_tensors(v, out)
    elif hasattr(obj, "__dict__") and not callable(obj):
        _held_tensors(vars(obj), out)
    return out


@pytest.mark.parametrize("B", [64, 45])
@pytest.mark.parametrize("name", CLAUSE_RUNNERS)
def test_a_clause_runner_returns_its_input_and_holds_its_buffers(name, B):
    """At a full (64) and a ragged (45) batch: the result is the input's
    storage and equals a run from a copy; a second call of the shape, from
    another state, runs on the same held buffers (the same tensors, at the
    same addresses) and leaves the first result, still held, as it was."""
    from odesat_tpu_torch.models.loop import copy_state
    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded

    fa, _ = compile_stream_sharded(_normalized_port("small.cnf"), 1)
    run = _clause_runner(name, fa)
    first = _clause_state(name, fa, B, 1)
    want = _clause_runner(name, fa)(copy_state(first))
    ptrs = [t.data_ptr() for t in first]
    got = run(first)
    assert [t.data_ptr() for t in got] == ptrs
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    held = [(t.data_ptr(), tuple(t.shape)) for t in _held_tensors(run.held, [])]
    assert held and len(run.held) == 1
    kept = copy_state(got)
    run(_clause_state(name, fa, B, 2))
    assert [(t.data_ptr(), tuple(t.shape)) for t in _held_tensors(run.held, [])] == held
    for a, b in zip(got, kept):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CLAUSE_RUNNERS)
def test_runners_of_every_chunk_length_share_one_set_of_buffers(name):
    """A solve builds a runner for each chunk length it runs (its inner
    chunk, a tail, the grown chunks): a formula's runners of one kind hold
    one set of buffers a batch shape between them (``ops/tiles.held_pool``),
    whatever their lengths, and give what a runner with a pool of its own
    gives; the pool goes with the last of them."""
    import gc

    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded
    from odesat_tpu_torch.ops.tiles import held_pool

    fa, _ = compile_stream_sharded(_normalized_port("small.cnf"), 1)
    long, short = _clause_runner(name, fa, 6), _clause_runner(name, fa, 3)
    assert long.held is short.held
    long(_clause_state(name, fa, 64, 1))
    held = [(t.data_ptr(), tuple(t.shape)) for t in _held_tensors(long.held, [])]
    got = short(_clause_state(name, fa, 64, 2))
    assert len(short.held) == 1
    assert [(t.data_ptr(), tuple(t.shape)) for t in _held_tensors(short.held, [])] == held
    alone, _ = compile_stream_sharded(_normalized_port("small.cnf"), 1)
    want = _clause_runner(name, alone, 3)(_clause_state(name, alone, 64, 2))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert held_pool(fa) is long.held
    del long, short
    gc.collect()
    assert held_pool(fa) == {}


def _normalized_port(name):
    return port_formula(jnormalize(jparse(os.path.join(os.path.dirname(__file__), "data",
                                                       name)))[1])


SIM = dict(step_size=0.01, steps=32)


def _sim_config(pkg, path, shard_chunk="auto", steps=32, resume=None):
    ode = (JODE if pkg == "jax" else ODEConfig)(step_size=0.01, steps=steps,
                                                shard_chunk=shard_chunk)
    kw = dict(batch_size=8, seed=0, chunk_steps=16, checkpoint_path=str(path),
              checkpoint_every_chunks=1)
    if resume is not None:
        kw["resume_from"] = str(resume)
    return (JSC if pkg == "jax" else SolverConfig)(ode=ode, **kw)


def _search_config(pkg, steps, shard_chunk="auto"):
    ode = (JODE if pkg == "jax" else ODEConfig)(steps=steps, shard_chunk=shard_chunk)
    return (JSC if pkg == "jax" else SolverConfig)(ode=ode, batch_size=8, seed=1, chunk_steps=16)


def _jax_mesh():
    """The JAX package's 1x2 clause mesh, on two of the CPU's devices."""
    import jax

    from odesat_tpu.parallel.mesh import make_mesh

    return make_mesh(1, 2, jax.devices()[:2])


MESH_CASES = ["simulate B6", "simulate B5", "resume B6", "stoch B9", "stoch B8", "hybrid",
              "stoch B9 sat", "stoch B8 sat", "hybrid sat"]


@pytest.fixture(scope="module")
def clause_mesh_runs(tmp_path_factory):
    """One 1x2 gloo world: each case of MESH_CASES as the package runs it
    and with the clause runners consuming their inputs (donation_worker),
    on hard.cnf (UNSAT: nothing solves, every run takes its whole budget)
    from one NumPy state for the ODE, the resume from the 16-step snapshot
    of a run of each kind; the "sat" cases on easy.cnf (satisfiable).
    Returns ``(values, tmp, arrays, hard, easy)``."""
    from odesat_tpu.parallel.sharded import compile_for_mesh as jcompile_for_mesh
    from odesat_tpu_torch.parallel import launch
    from tests import donation_worker as dw

    tmp = tmp_path_factory.mktemp("clause_mesh")
    hard = jnormalize(jparse(os.path.join(os.path.dirname(__file__), "data", "hard.cnf")))[1]
    formula, sat = _normalized_port("hard.cnf"), _normalized_port("easy.cnf")
    easy = jnormalize(jparse(os.path.join(os.path.dirname(__file__), "data", "easy.cnf")))[1]
    jfa = jcompile_for_mesh(hard, _sim_config("jax", tmp / "x.npz"), _jax_mesh())
    arrays = numpy_state(jfa, 8, seed=5)
    calls = []
    for consume in (False, True):
        tag = "got" if consume else "plain"
        for path in ("B6", "B5"):
            calls.append((dw.mesh_run, ("simulate", consume, formula,
                                        _sim_config("torch", tmp / f"{path}_{tag}.npz",
                                                    "auto" if path == "B6" else "off"),
                                        arrays)))
        calls.append((dw.mesh_run, ("simulate", consume, formula,
                                    _sim_config("torch", tmp / f"part_{tag}.npz", steps=16),
                                    arrays)))
        calls.append((dw.mesh_run, ("simulate", consume, formula,
                                    _sim_config("torch", tmp / f"resumed_{tag}.npz",
                                                resume=tmp / f"part_{tag}.npz"), arrays)))
        for path in ("auto", "off"):
            calls.append((dw.mesh_run, ("stoch", consume, formula,
                                        _search_config("torch", 64, path))))
        calls.append((dw.mesh_run, ("hybrid", consume, formula, _hybrid_config("torch", 64))))
        for path in ("auto", "off"):
            calls.append((dw.mesh_run, ("stoch", consume, sat,
                                        _search_config("torch", SAT_STEPS, path))))
        calls.append((dw.mesh_run, ("hybrid", consume, sat,
                                    _hybrid_config("torch", SAT_STEPS))))
    values = launch.spawn(launch.run_all, 1, 2, "gloo", "cpu", timeout_s=300, args=(calls,))
    return values, tmp, arrays, hard, easy


SAT_STEPS = 512  # the budget of the "sat" cases; JAX's 1x2 mesh solves easy.cnf in 32-48


def _hybrid_config(pkg, steps):
    return (JSC if pkg == "jax" else SolverConfig)(
        ode=(JODE if pkg == "jax" else ODEConfig)(steps=steps, step_size=0.01), batch_size=8,
        seed=0, chunk_steps=16)


def _satisfies(assignment, formula) -> bool:
    from odesat_tpu_torch.cnf import evaluate_cnf

    return evaluate_cnf(dict(enumerate(map(bool, assignment))), port_formula(formula))


@pytest.mark.parametrize("case", MESH_CASES)
def test_clause_mesh_with_consumed_inputs_equals_unwrapped_and_jax(clause_mesh_runs, monkeypatch,
                                                                   case):
    """At S=2 (gloo, the plain versions of B6, B5, B9 and B8): each entry
    point gives with consumed inputs what it gives as it runs, bit for bit
    (results and snapshots), and consumed something on every rank; the ODE
    runs' snapshots equal the JAX package's clause mesh (1x2 CPU mesh) from
    the same state within rtol 2e-4 / atol 2e-5 (done exactly), a resumed
    run's the whole run's bit for bit. The stoch search and the hybrid draw
    their flips from the port's generators, not JAX's keys, so their runs
    are held against JAX's on its 1x2 clause mesh by outcome: on hard.cnf
    both end unsolved after exactly their budget, on easy.cnf both solve
    and the port's assignment satisfies the formula. Flip for flip, B8's
    plain version is held against JAX's Pallas kernel in
    tests/test_torch_stoch_shard.py::test_eval_plain_equals_pallas, and the
    S=2 path against S=1 in test_stoch_clause_mesh_s2_equals_s1_flip_for_flip."""
    from odesat_tpu.models import ode as jode
    from odesat_tpu.models.hybrid import hybrid_search as jhybrid
    from odesat_tpu.models.stoch import search as jsearch
    from odesat_tpu.parallel.sharded import simulate_batch_sharded as jsimulate
    from tests import donation_worker as dw

    values, tmp, arrays, hard, easy = clause_mesh_runs
    half = len(values) // 2
    i = {"simulate B6": 0, "simulate B5": 1, "resume B6": 3, "stoch B9": 4, "stoch B8": 5,
         "hybrid": 6, "stoch B9 sat": 7, "stoch B8 sat": 8, "hybrid sat": 9}[case]
    (plain, _), (got, filled) = values[i], values[half + i]
    assert filled > 0
    for name in ("steps", "solved_index", "engine", "solved"):
        assert getattr(got, name, None) == getattr(plain, name, None), name
    for name in ("done", "assignment"):  # a HybridResult has no done
        if hasattr(plain, name):
            np.testing.assert_array_equal(getattr(got, name), getattr(plain, name))
    sat = case.endswith("sat")
    formula, budget = (easy, SAT_STEPS) if sat else (hard, 64)
    if case.startswith("stoch"):
        want = jsearch(formula, _search_config("jax", budget), mesh=_jax_mesh())
        if sat:
            assert got.solved_index is not None and want.solved_index is not None
            assert _satisfies(got.best_assignment(), formula)
            assert got.steps <= budget
        else:
            assert got.solved_index is None and want.solved_index is None
            assert got.steps == want.steps == 64
        return
    if case.startswith("hybrid"):
        want = jhybrid(formula, _hybrid_config("jax", budget), mesh=_jax_mesh())
        assert got.solved == want.solved == sat
        if sat:
            assert _satisfies(got.assignment, formula)
        else:
            assert (got.engine, got.steps) == (want.engine, want.steps) == ("none", 64)
        return
    path = "B6" if case != "simulate B5" else "B5"
    name = "resumed" if case == "resume B6" else path
    snaps = [dw.snapshot(tmp / f"{name}_{tag}.npz") for tag in ("plain", "got")]
    if case == "resume B6":
        snaps.append(dw.snapshot(tmp / "B6_plain.npz"))  # the whole run
    fields = ("v", "xs", "xl", "dt", "done")
    for snap in snaps[1:]:
        assert int(snap["steps"]) == int(snaps[0]["steps"]) == 32
        for f in fields:
            np.testing.assert_array_equal(snap[f"field_{f}"], snaps[0][f"field_{f}"], err_msg=f)
    monkeypatch.setattr(jode, "init_state", lambda *a, **k: jax_state(arrays))
    jsimulate(hard, _sim_config("jax", tmp / f"jax_{path}.npz",
                                "auto" if path == "B6" else "off"), _jax_mesh())
    want = dw.snapshot(tmp / f"jax_{path}.npz")
    assert int(want["steps"]) == 32
    for f in fields:
        a, b = snaps[0][f"field_{f}"], want[f"field_{f}"]
        if f == "done":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=f)
