"""Load-robust time-to-solution protocol with exact step resolution: the
port of ``odesat_tpu.utils.tts``.

The north-star metric is time to solution on uf250-class instances. A
wall clock mixes the solver with the host, so the protocol splits a run
into a deterministic steps-to-solution, a compute time from the separately
measured steady-state kernel rate, a dispatch share (chunks x the measured
launch round trip) and a residual that names the host's noise
(:func:`tts_breakdown`).

Chunked early exit makes steps-to-solution chunk-granular, so
:func:`solve_exact` bisects the final chunk: ``done`` latches, so
power-of-two sub-chunks run from the pre-chunk state find the exact first
step at which a row is done in about log2(chunk) short launches. The
integration is the production path (``models/ode.make_chunk_runner``,
the same kernels, B1 on a card); only the driving loop differs.

A kernel runner (B1, B2) with a budget of at least two chunks takes the
JAX package's one-dispatch path: the whole chunk ladder in one dispatch of
the multi-chunk runner (on a card one graph launch that stops on the card,
``ops/device_loop.py``), then, off the clock, a replay of all but the last
chunk from the initial state through the same runner (the kernels are
deterministic), and the bisection as before. ``chunks`` then counts the
dispatch as one, as JAX's does. Other runners, and budgets under two
chunks, stay host-paced: there the runners write fresh outputs and leave
their input as it was, so the loop keeps the pre-chunk state: no replay.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class ExactSolve:
    """Outcome of :func:`solve_exact`: the exact first-solve step (or the
    budget when unsolved), the solve's own chunk count and wall time
    (bisection probes excluded: they are measurement apparatus, not part
    of a production solve)."""

    steps: int
    solved: bool
    chunks: int
    wall_s: float
    solved_index: Optional[int] = None  # first done trajectory
    assignment: Optional[np.ndarray] = None  # that trajectory's readout


def measure_dispatch_latency(n: int = 15, device="cuda") -> float:
    """Median round trip of a tiny op on ``device`` (one launch on CUDA,
    then a synchronize), seconds."""
    device = torch.device(device)
    x = torch.zeros((8, 128), device=device)

    def once():
        y = x + 1.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return y

    once()  # first launch: context and allocator warm-up
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        once()
        lat.append(time.perf_counter() - t0)
    return float(np.median(lat))


def _pow2_ladder(chunk: int) -> list[int]:
    """Descending powers of two that can compose any offset < chunk."""
    sizes = []
    s = 1
    while s < chunk:
        s *= 2
    s //= 2
    while s >= 1:
        sizes.append(s)
        s //= 2
    return sizes


def evict_formula(runner_cache: dict, fa) -> None:
    """Drop every runner :func:`solve_exact` cached for ``fa``. A shared
    cache pins each formula (the value holds ``fa``, so a recycled ``id``
    never aliases a dead formula's runner), so a long multi-instance sweep
    evicts each instance when done with it, or memory grows with every
    instance (its tables on the card) ever solved."""
    for key in [k for k in runner_cache if k[0] == id(fa)]:
        del runner_cache[key]


def solve_exact(
    fa,
    ode,
    batch: int,
    generator,
    chunk: int,
    budget: int,
    runner_cache: Optional[dict] = None,
    readout: bool = False,
    *,
    device,
) -> ExactSolve:
    """Run a trajectory batch on ``device`` until any trajectory solves (or
    ``budget`` steps), resolving the EXACT first-solve step by final-chunk
    bisection. The initial state comes from ``models/ode.init_state`` with
    ``generator`` (a ``torch.Generator`` on ``device``).

    ``runner_cache`` may be shared across instances. Entries are keyed by
    (formula identity, chunk length), because a chunk runner holds the
    formula's content (a kernel's tables), not just its shape; each entry
    pins its formula, so sweeps :func:`evict_formula` each instance when
    done with it. The solve chunk's runner (the one-dispatch path: its
    graph, at a bound of one chunk) is warmed on the initial state outside
    the timed region (its output is discarded)."""
    from odesat_tpu_torch.models import ode as ode_mod
    from odesat_tpu_torch.ops.device_loop import KernelChunk
    from odesat_tpu_torch.ops.scan_chunk import ScanChunk
    from odesat_tpu_torch.utils.timing import sync

    if runner_cache is None:
        runner_cache = {}
    device = torch.device(device)
    zeta = ode.resolve_zeta(fa.density)

    def runner(n):
        key = (id(fa), n)
        if key not in runner_cache:
            runner_cache[key] = (ode_mod.make_chunk_runner(fa, zeta, ode, n, device), fa)
        return runner_cache[key][0]

    dev = ode_mod.formula_device(fa, device, dtype=ode_mod.state_dtype(ode))
    state = ode_mod.init_state(fa, batch, generator, ode, device)

    def finish(cur, final, base, n, chunks, wall):
        # bisect inside the final chunk: the smallest k in (0, n] with
        # done.any(). done latches, so each probe either crosses the
        # first-solve step (keep it as the earliest solved state) or lands
        # before it (advance from it)
        off = 0
        for size in _pow2_ladder(n):
            if off + size >= n:  # can't advance past the known-solved point
                continue
            probe = runner(size)(cur, dev)
            if sync(probe).any():
                final = probe
                continue
            cur = probe
            off += size
        # final's lowest-indexed done trajectory latched at some step no
        # later than final's and has been frozen since (the readout is one
        # update past detection, src/system.rs:238)
        idx = int(np.flatnonzero(sync(final))[0])
        assignment = (final.v[idx, : fa.n_vars] > 0.0).cpu().numpy() if readout else None
        return ExactSolve(steps=base + off + 1, solved=True, chunks=chunks, wall_s=wall,
                          solved_index=idx, assignment=assignment)

    # the kernels' chunks only: JAX's scan chunk stays host-paced here too
    # (its core_only refuses a while program that would recompile a formula)
    if (budget // chunk >= 2 and isinstance(runner(chunk), KernelChunk)
            and not isinstance(runner(chunk), ScanChunk)):
        return _one_dispatch(fa, zeta, ode, chunk, budget, device, state, dev, runner, finish)

    sync(runner(min(chunk, budget))(state, dev) if budget > 0 else state)  # warm-up
    steps = 0
    chunks = 0
    prev = state
    n = 0
    t0 = time.perf_counter()
    while steps < budget:
        n = min(chunk, budget - steps)
        prev = state
        state = runner(n)(state, dev)
        steps += n
        chunks += 1
        if sync(state).any():
            break
    else:
        return ExactSolve(steps=budget, solved=False, chunks=chunks,
                          wall_s=time.perf_counter() - t0)
    wall = time.perf_counter() - t0
    return finish(prev, state, steps - n, n, chunks, wall)


def _one_dispatch(fa, zeta, ode, chunk, budget, device, state, dev, runner,
                  finish) -> ExactSolve:
    """:func:`solve_exact`'s one-dispatch path (JAX utils/tts.py:180-232):
    one timed dispatch of ``budget // chunk`` chunks from the initial
    state, the budget tail shorter than a chunk host-paced, then off the
    clock the replay of all but the final chunk and the bisection."""
    from odesat_tpu_torch.models.ode import make_multi_chunk_runner
    from odesat_tpu_torch.utils.timing import sync

    def multi(n):
        return make_multi_chunk_runner(fa, zeta, ode, chunk, n, device, chunk=runner(chunk))

    # warm the runner off the clock at ONE chunk: the bound is written at
    # each launch, so this builds the very graph the timed dispatch reuses
    sync(multi(1)(state, dev)[0])
    t0 = time.perf_counter()
    out, adv = multi(budget // chunk)(state, dev)  # the dispatch copies: state stays
    done = sync(out)
    wall = time.perf_counter() - t0
    chunks, steps = 1, int(adv)
    if not done.any():
        rem = budget - steps
        if rem > 0:  # the budget tail, shorter than one chunk, host-paced
            before_tail = out
            t1 = time.perf_counter()
            out = runner(rem)(out, dev)
            done = sync(out)
            wall += time.perf_counter() - t1
            chunks += 1
            if done.any():
                return finish(before_tail, out, steps, rem, chunks, wall)
        return ExactSolve(steps=budget, solved=False, chunks=chunks, wall_s=wall)
    n_chunks = steps // chunk
    prev = multi(n_chunks - 1)(state, dev)[0] if n_chunks > 1 else state
    return finish(prev, out, steps - chunk, chunk, chunks, wall)


def tts_breakdown(steps: int, chunks: int, batch: int, kernel_rate: float,
                  dispatch_s: float, wall_s: float) -> dict:
    """Split a wall-clock TTS into compute / dispatch / residual."""
    compute = steps * batch / kernel_rate
    overhead = chunks * dispatch_s
    return {
        "steps": int(steps),
        "compute_s": float(compute),
        "dispatch_s": float(overhead),
        "wall_s": float(wall_s),
        "residual_s": float(wall_s - compute - overhead),
    }
