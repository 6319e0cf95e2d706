"""B7 fused into B6's and B9's launches (odesat_tpu_torch/ops/butterfly.py,
csrc/bfly_tree.cuh), on the CPU.

* The slot schedule: one counter a rank (a launch waits until every peer's
  flag is at least its number, then raises its own past it) and K slots a
  mode (launch j writes slot j mod K), as a pure Python model of the
  launches of a fixed B6 chunk, an adaptive one, a B9 chunk, standalone
  calls and a sequence that mixes them. Every interleaving of S = 2, 3 and 4
  ranks is explored (the state is each rank's position in its program, so
  the search is exhaustive): no launch reads a slot that does not hold the
  call it consumes, on any rank, and no rank waits forever; K - 1 slots fail.
* The plain versions: B6's phases and B9's launch fed S partials, which
  they combine in the butterfly's tree, equal the path that combined them
  first into one reduced buffer (the standalone call's path), bit for bit,
  at S = 2, 3 and 4.
* The ``--shard-chunk off`` runners sum through ``ops.butterfly.butterfly``
  (counted in a gloo world), so that B5 equals B6 and the B8 path the B9
  chunk bit for bit at S = 4.

The kernels run only on the card (tests/test_torch_cuda.py, chip_smoke.py).
This module imports no jax: its world's ranks import it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu_torch.cnf import CNFFormula, normalize_cnf_variables  # noqa: E402
from odesat_tpu_torch.ops import butterfly as bf  # noqa: E402
from odesat_tpu_torch.ops import shard_chunk as sch  # noqa: E402
from odesat_tpu_torch.ops import stoch_chunk as sc  # noqa: E402
from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded, shard_spec  # noqa: E402
from odesat_tpu_torch.ops.tiles import tile, untile  # noqa: E402
from odesat_tpu_torch.parallel import launch, sharded  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from odesat_tpu_torch.utils.generate import random_ksat  # noqa: E402

# ------------------------------------------------------- the slot schedule

# K of each runner (ops/butterfly.py): 1 + the furthest distance back at
# which a launch reads a call's partial
K = {"fixed": 2, "adaptive": 3, "b9": 2, "standalone": 2}


def _launches(mode, steps):
    """One runner's launches: (reads, writes), reads the distances back of
    the calls it consumes (0: its own, a standalone call's), as the runners
    of ops/shard_chunk.py and ops/stoch_chunk.py and butterfly_cuda make
    them."""
    if mode == "fixed":  # step t applies t - 1; the closing apply reads the last
        return [((1,) if t else (), True) for t in range(steps)] + [((1,), False)]
    if mode == "adaptive":  # first reads the last first and half; half its first
        out = []
        for t in range(steps):
            out += [((2, 1) if t else (), True), ((1,), True)]
        return out + [((2, 1), False)]
    if mode == "b9":  # launch t flips with t - 1; the last launch only flips
        return [((1,) if t else (), t < steps) for t in range(steps + 1)]
    return [((0,), True)] * steps  # standalone: each call reads its own slot


def _program(runners, slots, ring=None):
    """One rank's stream as actions, with the communicator's bookkeeping:
    ("wait", v) holds until every peer's flag is at least v; ("kernel",
    reads, write) reads slots [(call, slot)] and writes (call, slot) or
    None; ("signal", v) raises the rank's flag to v. ``runners``: (mode,
    k, steps); launch j writes slot j mod k of its runner, or j mod ``ring``
    whatever the runner when ``ring`` is given (the communicator's one
    mapping); ``slots``: the physical slots."""
    prog, count, waited = [], 0, 0
    for mode, k, steps in runners:
        n = ring or k
        assert n <= slots
        for reads, writes in _launches(mode, steps):
            if waited < count:
                prog.append(("wait", count))
                waited = count
            j = count
            if mode == "standalone":  # the copy into the slot, the raise, the wait, the kernel
                prog += [("kernel", (), (j, j % n)), ("signal", j + 1), ("wait", j + 1),
                         ("kernel", ((j, j % n),), None)]
                waited = j + 1
            else:
                prog += [("kernel", tuple((j - d, (j - d) % n) for d in reads),
                          (j, j % n) if writes else None), ("signal", j + 1)]
            count += 1
    return prog


def _explore(prog, S, slots):
    """Every interleaving of S ranks running ``prog``: returns None when no
    read finds another call in its slot and every state can move, else what
    went wrong."""
    n = len(prog)
    flag, contents = [0], [(-1,) * slots]  # after each prefix of the program
    for act in prog:
        f, c = flag[-1], list(contents[-1])
        if act[0] == "signal":
            f = act[1]
        elif act[0] == "kernel" and act[2] is not None:
            c[act[2][1]] = act[2][0]
        flag.append(f)
        contents.append(tuple(c))
    seen = set()
    stack = [(0,) * S]
    while stack:
        pcs = stack.pop()
        if pcs in seen:
            continue
        seen.add(pcs)
        moved = False
        for r in range(S):
            pc = pcs[r]
            if pc == n:
                continue
            act = prog[pc]
            if act[0] == "wait" and any(flag[pcs[q]] < act[1] for q in range(S) if q != r):
                continue
            if act[0] == "kernel":
                for call, slot in act[1]:
                    for q in range(S):
                        if contents[pcs[q]][slot] != call:
                            return (f"rank {r} at action {pc} reads call {call} from rank {q}'s "
                                    f"slot {slot}, which holds {contents[pcs[q]][slot]}")
            moved = True
            stack.append(pcs[:r] + (pc + 1,) + pcs[r + 1:])
        if not moved and any(pc < n for pc in pcs):
            return f"no rank can move at {pcs}"
    return None


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("mode", ["fixed", "adaptive", "b9", "standalone"])
def test_k_slots_are_safe_and_k_minus_one_are_not(mode, S):
    """Two chunks (or three standalone calls) on one counter, every
    interleaving of S ranks: K slots never let a launch read a slot that a
    peer has overwritten or not yet written; K - 1 slots do."""
    k = K[mode]
    runs = [(mode, k, 2)] * (1 if mode == "standalone" else 2)
    if mode == "standalone":
        runs = [(mode, k, 3)]
    assert _explore(_program(runs, k), S, k) is None
    bad = [(mode, k - 1, steps) for _, _, steps in runs]
    assert _explore(_program(bad, k - 1), S, k - 1) is not None


@pytest.mark.parametrize("S", [2, 3])
def test_runners_of_other_k_share_one_counter_through_one_ring(S):
    """A fixed chunk, standalone calls, an adaptive chunk, a B9 chunk and
    a standalone call again on one counter: with every launch j on slot j
    mod ``bf.SLOTS`` (the communicator's one mapping) every interleaving is
    safe; with each runner on its own K it is not, since a standalone call
    reads its slot after its raise and the next runner's first launch may
    take that slot at once."""
    runs = [("fixed", 2, 1), ("standalone", 2, 2), ("adaptive", 3, 1), ("b9", 2, 1),
            ("standalone", 2, 1)]
    assert _explore(_program(runs, bf.SLOTS, bf.SLOTS), S, bf.SLOTS) is None
    assert _explore(_program(runs, bf.SLOTS), S, bf.SLOTS) is not None


# ------------------------------------------------------- the plain versions


def _fa(S, seed=0):
    clauses = [c for k in (2, 3, 5) for c in random_ksat(30, 80, k=k, seed=seed + k).clauses]
    return compile_stream_sharded(normalize_cnf_variables(CNFFormula(clauses, 30))[1], S)[0]


def _chunk_buffers(fa, B, fixed, rng):
    Np, ml = fa.n_vars_padded, fa.shard_plan.mp_local

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)

    b = sch.ChunkBuffers(put(rng.uniform(-1, 1, (B, Np))), put(rng.uniform(0.001, 0.999, (B, ml))),
                         put(rng.uniform(1, 50, (B, ml))), put(rng.uniform(0.01, 0.05, B)),
                         put(rng.random(B) < 0.2, torch.bool), put(rng.uniform(-2, 2, (B, Np + 1))))
    if not fixed:
        b = b._replace(acc2=put(rng.uniform(-2, 2, (B, Np + 1))),
                       dxs1=put(rng.uniform(-1, 1, (B, ml))), dxl1=put(rng.uniform(-1, 1, (B, ml))))
    return b


def _partials(shape, S, rng, flag):
    """S partials whose rank-order and tree-order sums round differently,
    column -1 drawn by ``flag``."""
    out = []
    for _ in range(S):
        a = rng.uniform(-1, 1, shape) * 10.0 ** rng.integers(-3, 6, shape)
        a[:, -1] = flag()
        out.append(torch.as_tensor(a.astype(np.float32)))
    return out


def _tree(parts, op):
    vals, w = list(parts), 1
    while w < len(vals):
        for i in range(0, len(vals) - w, 2 * w):
            vals[i] = op(vals[i], vals[i + w])
        w *= 2
    return vals[0]


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_b6_plain_fed_partials_equals_the_reduced_path(mode, S):
    """Each B6 phase fed S partials (its tree: sums, row Np of the second
    pass's by max) equals the phase reading one buffer reduced in that
    tree first, as the standalone call's path does, bit for bit; the partials'
    sums round differently in rank order, so the tree is what is held."""
    fa = _fa(S)
    fixed = mode == "fixed"
    ode = ODEConfig(step_size=0.02 if fixed else None)
    rng = np.random.default_rng(S)
    B = 9
    phases = ([("step", True), ("apply", False)] if fixed else
              [("first", True), ("half", False), ("commit", False)])
    for s in range(S):
        spec = shard_spec(fa, 0.05, ode, "cpu", s)
        b = _chunk_buffers(fa, B, fixed, rng)
        shape = tuple(b.acc.shape)
        p1 = _partials(shape, S, rng, lambda: rng.integers(0, 2, B) * (rng.random(B) < 0.7))
        p2 = None if fixed else _partials(shape, S, rng, lambda: rng.uniform(0, 1e-2, B))
        red = _tree(p1, torch.add)
        ring = p1[0]
        for p in p1[1:]:
            ring = ring + p
        if S == 4:  # ((a0 + a1) + a2) + a3 is not the tree's (a0 + a1) + (a2 + a3)
            assert not torch.equal(red, ring)
        reduced = b._replace(acc=red)
        if not fixed:
            red2 = _tree(p2, torch.add)
            red2[:, -1] = _tree([p[:, -1] for p in p2], torch.maximum)
            reduced = reduced._replace(acc2=red2)
        for phase, apply in phases:
            got = sch.shard_chunk_plain(phase, b, spec, apply, (p1, p2))
            want = sch.shard_chunk_plain(phase, reduced, spec, apply)
            written = {"step": "acc", "first": "acc", "half": "acc2"}.get(phase)
            for name in ("v", "xs", "xl", "dt", "done", "dxs1", "dxl1", written):
                if name is None or getattr(got, name) is None:
                    continue
                assert torch.equal(getattr(got, name), getattr(want, name)), (phase, name)
            tiled = sch.shard_chunk_plain_tiled(phase, sch.ChunkBuffers(*(
                None if t is None else tile(t) for t in b)), spec, apply,
                ([tile(p) for p in p1], None if p2 is None else [tile(p) for p in p2]))
            assert torch.equal(untile(tiled.v, B), got.v), phase


@pytest.mark.parametrize("S", [2, 3, 4])
def test_b9_plain_fed_partials_equals_the_reduced_path(S):
    """B9's launch fed S partials (summed in the tree) flips as the launch
    reading one reduced buffer does, bit for bit, tiled or not."""
    fa = _fa(S, seed=3)
    rng = np.random.default_rng(10 + S)
    B, Np = 9, fa.n_vars_padded
    for s in range(S):
        spec = sc.stoch_shard_spec(fa, "cpu", s)
        v = torch.as_tensor(rng.random((B, Np)) < 0.5)
        xl = torch.as_tensor(rng.integers(1, 3001, (B, fa.shard_plan.mp_local)).astype(np.int32))
        done = torch.as_tensor(rng.random(B) < 0.2)
        parts = []
        for _ in range(S):
            a = rng.integers(0, 40, (B, 2 * Np + 1)).astype(np.float32)
            a[:, Np:2 * Np] = np.minimum(a[:, Np:2 * Np], a[:, :Np])
            a[:, 2 * Np] = rng.integers(0, 2, B) * (rng.random(B) < 0.5)
            parts.append(torch.as_tensor(a))
        acc = torch.full_like(parts[0], 7.0)
        args = (spec, False, 4321, sc.traj_block(B), 3, True, True)
        got = sc.stoch_shard_step_plain(v, xl, done, acc, *args, parts=parts)
        want = sc.stoch_shard_step_plain(v, xl, done, _tree(parts, torch.add), *args)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        tiled = sc.stoch_shard_step_plain_tiled(*(tile(t) for t in (v, xl, done, acc)), *args,
                                                parts=[tile(p) for p in parts])
        for x, y in zip(tiled, got):
            assert torch.equal(untile(x, B), y)


# ------------------------------------------------------- the off-path runners


def counted(mesh, device, fn, *args):
    """``fn(mesh, device, *args)`` with every call of
    ``ops.butterfly.butterfly`` counted: ``(value, calls)`` (for a world's
    ranks)."""
    calls = []
    real = bf.butterfly

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    bf.butterfly = counting
    try:
        return fn(mesh, device, *args), len(calls)
    finally:
        bf.butterfly = real


def test_off_runners_sum_through_b7_and_b5_equals_b6_at_s4():
    """A world of four gloo ranks: the ODE clause mesh through B5
    (``--shard-chunk off``, fixed and adaptive) and the stoch clause path
    through B8 sum through ``ops.butterfly.butterfly`` (one call a fixed
    step, three an adaptive one, one a stoch step), so that B5 equals B6
    and the B8 path the B9 chunk bit for bit; the chunks call it never."""
    fa = _fa(4, seed=5)
    rng = np.random.default_rng(6)
    B, steps = 8, 5
    xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
    arrays = (rng.uniform(-1, 1, (B, fa.n_vars_padded)).astype(np.float32), xs,
              np.ones_like(xs), np.full(B, 0.01, np.float32), rng.random(B) < 0.2)
    calls = [(counted, (sharded.run_ode_cases, [(fa, 0.05, ODEConfig(step_size=st, shard_chunk=c),
                                                 steps, arrays)]))
             for c in ("auto", "off") for st in (0.01, None)]
    calls += [(counted, (sharded.run_stoch_clause, fa, 2, 3, 5, "float32", B, mode))
              for mode in ("auto", "off")]
    values = launch.spawn(launch.run_all, 1, 4, "gloo", "cpu", timeout_s=300, args=(calls,))
    assert [n for _, n in values] == [0, 0, steps, 3 * steps, 0, 6]
    (b6f,), (b6a,), (b5f,), (b5a,) = (v for v, _ in values[:4])
    for a, b in ((b6f, b5f), (b6a, b5a)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(values[4][0], values[5][0]):
        np.testing.assert_array_equal(x, y)
