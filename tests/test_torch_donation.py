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
from tests.torch_parity import jax_state, numpy_state  # noqa: E402


def _poison(state, out) -> int:
    """Fill every field of ``state`` that shares no memory with ``out``, as
    a consumed donated buffer may hold anything; returns how many."""
    kept = {t.untyped_storage().data_ptr() for t in out}
    n = 0
    for t in state:
        if t.numel() and t.untyped_storage().data_ptr() not in kept:
            t.fill_(float("nan") if t.is_floating_point() else
                    True if t.dtype == torch.bool else -1)
            n += 1
    return n


def consuming(monkeypatch):
    """Make every chunk runner built with ``donate`` (the default) and every
    multi-chunk dispatch consume its input, for as long as ``monkeypatch``'s
    context lasts. Returns the count of fields filled, so that a case can
    show that its path consumed something."""
    filled = {"n": 0}

    def chunk_runners(build):
        def make(*a, **k):
            chunk = build(*a, **k)
            if chunk.donate:  # JAX's donate=False runners keep their input
                fn = chunk.fn

                def run(state, *args):
                    out = fn(state, *args)
                    filled["n"] += _poison(state, out)
                    return out

                chunk.fn = run
            return chunk

        return make

    def dispatches(build):
        def make(*a, **k):
            multi = build(*a, **k)

            def run(state, *args):
                out, steps = multi(state, *args)
                filled["n"] += _poison(state, out)
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
