"""The trajectory mesh's device loop (odesat_tpu_torch/ops/device_loop.py,
csrc/device_loop.cu; parallel/sharded.make_sharded_multi_runner), on the
CPU.

* The stop exchange: a Python model of the head and decide kernels of
  every rank of a trajectory group, written as the kernels do it (an
  exchange publishes ``(s, bit)`` to word ``s & 1`` of the rank's ring of
  two, then reads each peer's word of ``s`` once it holds ``s``, then
  combines the bits: OR, AND with ``stop_all``; the head exchanges when the
  bound is above 0, the decide kernel while fewer than the bound chunks
  ran). Every interleaving of T = 2, 3 and 4 ranks is explored over back to
  back dispatches of bounds 1, 0, 3 and 2, with a stop raised on one rank at
  entry and after each chunk, and on every rank, under ``any`` and ``all``:
  every rank takes the same decision at every exchange, runs the chunks
  the host loop's rule gives, and no rank reads a word that its peer has
  not published for that exchange, nor waits forever. One word a rank
  fails, read as it stands and read with "a later exchange means go on".
* The routing (``parallel/sharded.mesh_loop_route``): the CPU, a clause
  mesh, the scan tier, the twin's steps (batch-shared adaptive dt) and a
  group over two hosts take the host loop; B1-B4 on a card, on one host,
  the device loop.
* Parity with JAX's dedicated program: a spawned gloo world of two
  trajectory ranks runs ``run_multi_cases`` through B1's plain version
  (easy.cnf, float32 fixed dt, a stop inside the dispatch, and a stop at
  entry on one rank only, under ``any`` and ``all``) against JAX's
  ``make_sharded_multi_runner(..., dv_strategy="fused")`` on a two-device
  CPU mesh in interpret mode from the same NumPy state: the same
  ``steps_advanced``, the states within rtol 2e-4 / atol 2e-5 (done
  exactly). The stoch kernels take their seeds from a torch generator and
  JAX's from its keys, so the stoch dispatch through B3's plain version is
  held, rank by rank, against the same rows' one-device dispatch with
  that rank's row generator: bit for bit, with the mesh stopping at the
  first chunk after which any rank's own run would stop.

The kernels run only on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 28).
"""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.cnf import parse_dimacs_file as jparse  # noqa: E402
from odesat_tpu.parallel import sharded as jsharded  # noqa: E402
from odesat_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from odesat_tpu.utils.config import ODEConfig as JODE  # noqa: E402
from odesat_tpu_torch.interop import (  # noqa: E402
    formula_arrays_from_numpy,
    stoch_state_from_numpy,
)
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.models import stoch as tstoch  # noqa: E402
from odesat_tpu_torch.models.loop import run_chunks  # noqa: E402
from odesat_tpu_torch.ops import fused_chunk as fc  # noqa: E402
from odesat_tpu_torch.parallel import launch, sharded  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from tests.torch_parity import assert_states_close, jax_state, numpy_state  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-5)

# ------------------------------------------------------- the stop exchange

BOUNDS = (1, 0, 3, 2)  # back-to-back dispatches: every bound from 0 to 3


def _expected(bounds, done_at, rule):
    """Each dispatch's chunks by the host loop's rule over the group: stop
    before a chunk once any rank (every rank, ``all``) is stopped; rank r
    is stopped once ``done_at[r]`` chunks have run (None: never)."""
    def stopped(total):
        bits = [d is not None and total >= d for d in done_at]
        return all(bits) if rule == "all" else any(bits)

    total, out = 0, []
    for b in bounds:
        n = 0
        while n < b and not stopped(total):
            total, n = total + 1, n + 1
        out.append(n)
    return tuple(out)


def _explore(T, bounds, done_at, rule, design):
    """Every interleaving of T ranks running ``bounds`` dispatches of the
    device loop, exchanging their stop bits by ``design``: "ring" (the
    kernels: word s & 1 of a ring of two, a read once it holds exchange s),
    "word" (one word a rank, read once it holds s or later, its bit taken
    as it stands) or "later" (one word, a later exchange read as "go on").
    Returns None when every rank takes the same decision at every exchange,
    runs the expected chunks and never reads a word of another exchange
    than its own, and no state is stuck; else what went wrong.

    A rank is (dispatch, stage, ran, total, exchanges, any, all, next
    peer, chunks a dispatch); stage 0 starts a dispatch (its head), 1
    publishes an exchange, 2 reads the next peer and, after the last,
    decides. Shared: each rank's words ((s, bit) or None) and the
    decisions taken, by exchange. A rank reads its peers in rank order: a
    word of exchange s stays until its owner publishes s + 2, which needs
    this rank's s + 1, so the order of the reads changes nothing."""
    want = _expected(bounds, done_at, rule)
    n_words = 2 if design == "ring" else 1
    start = (tuple((0, 0, 0, 0, 0, False, False, 0, ()) for _ in range(T)),
             tuple((None,) * n_words for _ in range(T)), ())
    seen, stack = set(), [start]
    while stack:
        state = stack.pop()
        if state in seen:
            continue
        seen.add(state)
        ranks, words, decided = state
        moved = False
        for r in range(T):
            d, stage, ran, total, count, any_, all_, q, hist = ranks[r]
            if d == len(bounds):
                continue
            bound = bounds[d]
            new_words, new_decided = words, decided
            if stage == 0:  # the head: no exchange at bound 0
                rank = (d + 1, 0, 0, total, count, False, False, 0, hist + (0,)) if bound == 0 \
                    else (d, 1, 0, total, count, False, False, 0, hist)
            elif stage == 1:  # publish (s, bit): a release store to the rank's word
                s = count + 1
                bit = done_at[r] is not None and total >= done_at[r]
                mine = list(words[r])
                mine[s % n_words] = (s, bit)
                new_words = words[:r] + (tuple(mine),) + words[r + 1:]
                rank = (d, 2, ran, total, s, bit, bit, 0, hist)
            else:  # read peer q (the next one), then decide
                s = count
                if q == r:
                    q += 1
                if q < T:
                    word = words[q][s % n_words]
                    if word is None or word[0] < s:
                        continue  # the poll waits
                    if word[0] > s and design == "ring":
                        return f"rank {r} found exchange {word[0]} of rank {q} at {s}"
                    bit = word[1] if word[0] == s or design == "word" else False
                    any_, all_ = any_ or bit, all_ and bit
                    q += 1
                    if q == r:
                        q += 1
                if q < T:
                    rank = (d, 2, ran, total, count, any_, all_, q, hist)
                else:
                    stop = all_ if rule == "all" else any_
                    if len(decided) >= s:
                        if decided[s - 1] != stop:
                            return f"rank {r} decided {stop} at exchange {s}, a peer the other"
                    elif len(decided) == s - 1:
                        new_decided = decided + (stop,)
                    else:
                        return f"rank {r} decided exchange {s} before exchange {s - 1}"
                    if stop:
                        rank = (d + 1, 0, 0, total, count, False, False, 0, hist + (ran,))
                    else:  # a chunk, then the decide kernel's test of the bound
                        ran, total = ran + 1, total + 1
                        rank = (d, 1, ran, total, count, False, False, 0, hist) if ran < bound \
                            else (d + 1, 0, 0, total, count, False, False, 0, hist + (ran,))
            moved = True
            stack.append((ranks[:r] + (rank,) + ranks[r + 1:], new_words, new_decided))
        if not moved:
            if any(rank[0] < len(bounds) for rank in ranks):
                return f"no rank can move at {ranks}"
            runs = {rank[8] for rank in ranks}
            if runs != {want}:
                return f"chunks a dispatch {sorted(runs)}, the rule gives {want}"
    return None


def _scenarios(T):
    """``done_at`` of each rank: none stopped; rank T - 1 alone stopped at
    entry or after chunk c; every rank stopped, rank 0 one chunk later."""
    total = sum(BOUNDS)
    out = [(None,) * T]
    for c in range(total + 1):
        out.append((None,) * (T - 1) + (c,))
        out.append((c + 1,) + (c,) * (T - 1))
    return out


@pytest.mark.parametrize("rule", ["any", "all"])
@pytest.mark.parametrize("T", [2, 3, 4])
def test_the_exchange_takes_one_decision_on_every_rank(T, rule):
    """The kernels' ring of two words: every interleaving of T ranks over
    dispatches of bounds 1, 0, 3 and 2, each stop scenario, under ``rule``:
    the same decision at every exchange and the host loop's chunks on every
    rank, including zero chunks from a state stopped at entry."""
    for done_at in _scenarios(T):
        assert _explore(T, BOUNDS, done_at, rule, "ring") is None, done_at


@pytest.mark.parametrize("design", ["word", "later"])
def test_one_word_a_rank_is_not_enough(design):
    """One word a rank: a peer that has gone on to the next exchange (after
    a chunk, or into its next dispatch after a stop) has overwritten the
    word this rank still had to read. Read as it stands, its bit is that of
    the next exchange; read as "go on", it hides the stop that ended the
    peer's dispatch: some interleaving makes the ranks decide apart."""
    found = [done_at for T in (2, 3) for rule in ("any", "all") for done_at in _scenarios(T)
             if _explore(T, BOUNDS, done_at, rule, design) is not None]
    assert found


# ------------------------------------------------------------ the routing


def _fa(data_dir, name="easy.cnf", dtype=np.float32):
    return formula_arrays_from_numpy(jcompile(jnormalize(jparse(os.path.join(data_dir, name)))[1],
                                              dtype=dtype))


def test_the_routing_of_a_mesh_dispatch(data_dir):
    fa = _fa(data_dir)
    fixed = ODEConfig(step_size=0.01)
    b1 = fc.make_fused_chunk(fa, 0.05, fixed, 8, "cpu")
    b3 = tstoch.make_stoch_chunk_runner(fa, 8, "cpu", torch.Generator().manual_seed(0),
                                        fused="on")
    scan = tode.make_chunk_runner(fa, 0.05, ODEConfig(step_size=0.01, dv_strategy="gather"), 8,
                                  "cpu")
    # a batch-shared adaptive dt runs the twin's steps, which all-reduce dt
    shared = sharded._step_chunk(lambda st, dev: st, 8)
    one_host = ("node0", "node0")
    route = sharded.mesh_loop_route
    assert route(b1, 2, 1, "cpu", ())[0] == "host"
    assert route(b1, 2, 1, "cuda", one_host) == ("device", "2 ranks exchange the stop on the card")
    assert route(b3, 4, 1, "cuda:0", ("n",) * 4)[0] == "device"
    assert route(b1, 1, 1, "cuda", ())[0] == "device"
    assert route(b1, 2, 2, "cuda", one_host)[0] == "host"
    assert route(scan, 2, 1, "cuda", one_host)[0] == "host"
    assert route(shared, 2, 1, "cuda", one_host)[0] == "host"
    assert "spans hosts" in route(b1, 2, 1, "cuda", ("node0", "node1"))[1]


def test_a_cpu_mesh_runner_is_the_host_loop(data_dir):
    """On the CPU the mesh's runner is models/loop.run_chunks (with
    MeshSync), which needs no world when nothing asks for the stop: a
    dispatch of bound 0."""
    fa = _fa(data_dir)
    b1 = fc.make_fused_chunk(fa, 0.05, ODEConfig(step_size=0.01), 8, "cpu")
    mesh = SimpleNamespace(n_traj=2, n_clause=1, traj_group=None)
    run = sharded.make_sharded_multi_runner(b1, 8, 0, mesh, "cpu")
    assert run.__qualname__ == run_chunks(b1, 8, 0).__qualname__
    state = tode.init_state(fa, 4, torch.Generator().manual_seed(0), ODEConfig(step_size=0.01),
                            "cpu")
    out, steps = run(state)
    assert steps == 0 and torch.equal(out.v, state.v)


# ------------------------------------------------- parity with JAX's program


def _entry_done(arrays, rows):
    v, xs, xl, dt, done = (a.copy() for a in arrays)
    done[list(rows)] = True
    return v, xs, xl, dt, done


@pytest.fixture(scope="module")
def ode_runs(data_dir):
    """easy.cnf, B=8 over two ranks, float32 fixed dt 0.05 through B1's
    plain version: 32-step chunks, bound 32 (the stop inside the dispatch);
    8-step chunks, bound 4, row 5 (rank 1's) done at entry, under any and
    all."""
    jfa = jcompile(jnormalize(jparse(os.path.join(data_dir, "easy.cnf")))[1], dtype=np.float32)
    fa = formula_arrays_from_numpy(jfa)
    base = numpy_state(jfa, 8, seed=3)
    entry = _entry_done(base, [5])
    cases = [(32, 32, "any", base), (8, 4, "any", entry), (8, 4, "all", entry)]
    ode = ODEConfig(step_size=0.05, dv_strategy="fused")
    out = launch.spawn(sharded.run_multi_cases, 2, 1, "gloo", "cpu", timeout_s=300,
                       args=([(fa, 0.01, ode, c, n, rule, a) for c, n, rule, a in cases],))
    return jfa, cases, out


@pytest.mark.parametrize("case", [0, 1, 2])
def test_mesh_dispatch_matches_jax_sharded_multi_runner(ode_runs, case):
    jfa, cases, out = ode_runs
    chunk_steps, bound, rule, arrays = cases[case]
    mesh = jmake_mesh(2, 1, devices=jax.devices()[:2])
    multi = jsharded.make_sharded_multi_runner(
        jfa, 0.01, JODE(step_size=0.05, dv_strategy="fused"), chunk_steps, bound, mesh,
        stop_on=rule)
    assert multi is not None  # JAX's dedicated program, not its host-paced fallback
    jst, jsteps = multi(jsharded.shard_state(jax_state(arrays), mesh))
    state, steps = out[case]
    assert steps == int(jsteps)
    if case == 0:
        assert chunk_steps < steps < chunk_steps * bound  # the stop inside the dispatch
    if case == 1:
        assert steps == 0  # rank 1 stopped at entry stops rank 0 too
    if case == 2:
        assert steps == chunk_steps * bound  # all: rank 0's rows are not done
    assert_states_close(state, jst, dt_rtol=2e-4, **F32)


def test_stoch_mesh_dispatch_equals_each_ranks_own_rows(data_dir):
    """B3's plain version over two ranks, easy.cnf B=16, 8-step chunks,
    bound 24: each rank's chains equal its rows' one-device dispatch with
    its row generator for the chunks the mesh ran, bit for bit, and the
    mesh ran as many as the first rank to stop; with a chain of rank 1 done
    at entry no rank runs a chunk."""
    fa = _fa(data_dir)
    B, chunk, bound, seed = 16, 8, 24, 7
    rng = np.random.default_rng(2)
    v = rng.random((B, fa.n_vars_padded)) < 0.5
    xl = np.ones((B, fa.n_clauses_padded), np.int32)
    done = np.zeros(B, bool)
    stopped = done.copy()
    stopped[B - 1] = True
    cases = [(fa, chunk, bound, seed, (v, xl, done), "on"),
             (fa, chunk, bound, seed, (v, xl, stopped), "on")]
    (mesh_state, steps), (entry_state, entry_steps) = launch.spawn(
        sharded.run_multi_stoch_cases, 2, 1, "gloo", "cpu", timeout_s=300, args=(cases,))
    assert entry_steps == 0
    np.testing.assert_array_equal(entry_state.v, v)
    own = []
    for r in range(2):
        rows = slice(r * B // 2, (r + 1) * B // 2)
        local = stoch_state_from_numpy(v[rows], xl[rows], done[rows], device="cpu")
        gen = sharded.row_generator(seed, SimpleNamespace(traj_index=r))
        runner = tstoch.make_stoch_chunk_runner(fa, chunk, "cpu", gen, fused="on")
        own.append(tstoch.make_multi_stoch_runner(runner, chunk, bound)(local)[1])
        gen = sharded.row_generator(seed, SimpleNamespace(traj_index=r))
        runner = tstoch.make_stoch_chunk_runner(fa, chunk, "cpu", gen, fused="on")
        want, _ = run_chunks(runner, chunk, steps // chunk)(local)
        for name, a, b in zip(("v", "xl", "done"), mesh_state, want):
            np.testing.assert_array_equal(a[rows], b.numpy(), err_msg=f"rank {r} {name}")
    assert steps == min(own) and 0 < steps < chunk * bound
