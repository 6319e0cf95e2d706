"""The chunked host loop (the port of ``odesat_tpu.models.loop``).

The ODE loop dispatches chunks of steps and checks exit conditions on the
host between chunks: step budget and tail chunks, multiplicative chunk
escalation, wall-clock budget, log and checkpoint cadence and the profiler
trace live here once, with the same arithmetic as the JAX package, so
``steps_run`` is the same number for the same config. The hybrid engine
(models/hybrid.py) drives its pairs of chunks through the same loop.

Escalation: every chunk boundary costs a host round trip, so after every
GROW_AFTER further chunks without stopping the chunk grows 16x up to
GROW_CAP; long runs approach the kernel's rate while fast solves keep the
fine early-exit window. Log and checkpoint cadence disable growth so the
interval stays what the user asked for.

On a mesh every rank runs this loop, and a rank that built another chunk
or stopped after another chunk would hang in the next collective. So with
``sync`` (``parallel/dist.MeshSync``) every decision is made from global
facts: the done flags of every rank, and the elapsed times all-reduced
with MAX; chunk sizes then follow from values that are equal everywhere.
"""

from __future__ import annotations

import contextlib
import os
import time

from odesat_tpu_torch.utils.logging import span

GROW_AFTER = 8
GROW_CAP = 32768

# per-slice traj-step target for the multi-chunk runner: one slice between
# host decisions stays short, so logging and interrupts keep their cadence
DISPATCH_TRAJ_STEPS = 1 << 28
DISPATCH_STEPS_CAP = 262144


def device_dispatch_plan(config, steps_budget):
    """Gate and size of the multi-chunk runner. Returns ``(eligible,
    dispatch_steps)``: ``eligible`` is the config-level gate (no chunk
    cadence, no wall-clock budget, a budget above one inner chunk);
    ``dispatch_steps`` is the nominal slice, never below
    ``config.chunk_steps``, scaled down with batch size and clipped to the
    step budget."""
    inner = config.chunk_steps
    eligible = (
        not config.wants_chunk_cadence()
        # a wall-clock budget is only checked between slices: a full
        # slice could overshoot it on a slow instance
        and config.wall_clock_budget_s is None
        and (steps_budget is None or steps_budget > inner)
    )
    dispatch = max(
        inner,
        min(DISPATCH_STEPS_CAP, DISPATCH_TRAJ_STEPS // max(config.batch_size, 1)),
    )
    if steps_budget is not None:
        dispatch = min(dispatch, steps_budget)
    return eligible, dispatch


def copy_state(state):
    """A copy of ``state``, every field cloned: what a caller that needs its
    entry state after a call that consumes it (a chunk runner's, a
    dispatch's: ``ops/device_loop.py``'s contract) passes to the call, as
    JAX's callers pass ``jax.tree.map(jnp.copy, state)`` to a donating
    one."""
    return type(state)(*(t.clone() for t in state))


def run_chunks(chunk, chunk_steps: int, max_chunks: int, stop_all: bool = False, sync=None):
    """``run(state) -> (state, steps_advanced)`` running up to
    ``max_chunks`` calls of ``chunk(state) -> state`` of ``chunk_steps``
    steps each, testing before each chunk whether any (or, with
    ``stop_all``, every) row is done, as the JAX package's
    ``lax.while_loop`` tests its ``cond`` (JAX models/ode.py:469-478): a
    state already stopped at entry comes back unchanged with 0 steps. One
    ``done`` read per chunk keeps the same early-exit window and an exact
    ``steps_advanced``. With ``sync`` the stop flag is all-reduced over the
    world before every chunk. It is the plain version of the device loop
    (``ops/device_loop.py``), which runs the same rule on the card."""

    def stop(done):
        if sync is not None:
            return sync.all(done) if stop_all else sync.any(done)
        return bool(done.all() if stop_all else done.any())

    def run(state):
        n = 0
        while n < max_chunks and not stop(state.done):
            state = chunk(state)
            n += 1
        return state, n * chunk_steps

    return run


@contextlib.contextmanager
def profiled(profile_dir):
    """A ``torch.profiler`` trace of the block (CPU activities, and CUDA ones
    where torch sees a card), written as a chrome trace
    ``trace_rank<R>.json`` into ``profile_dir`` (R = 0 off a mesh). With no
    directory nothing is traced. The JAX package brackets its loop with
    ``jax.profiler`` the same way. A process's first session records every
    kernel; later sessions in the same process missed the first launch of
    each kernel (torch 2.11, CUDA 12.8, an H100), so trace a solve in a
    process of its own, as the CLI does. Inside a session already recording
    (``models/ode.simulate_batch``'s around the whole solve, or a caller's)
    it adds none: that session's trace holds the block."""
    import torch

    if not profile_dir or torch._C._autograd._profiler_enabled():
        yield
        return
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace_rank{rank}.json"))


def drive_chunks(
    state,
    make_runner,
    config,
    budget,
    should_stop,
    steps_resumed: int = 0,
    chunk_steps: int | None = None,
    sync=None,
    save=None,
    log=None,
    grow: bool = True,
    cadence_first: bool = False,
):
    """Run ``state = runner(state)`` chunks until ``should_stop(state,
    done)`` (done arrives as a host numpy array), the step budget, or the
    wall-clock budget. ``make_runner(n) -> (state -> state)`` builds a
    runner advancing every trajectory n steps; a runner may instead return
    ``(state, steps_advanced)`` when it stops early (models/ode.
    make_multi_chunk_runner), and the actual advance is then credited
    instead of the nominal n, so a state must never be a bare tuple.
    Returns ``(state, steps_run, wall_time_s)``. ``sync`` (a
    ``parallel/dist.MeshSync``) makes the done flags and the clocks global
    on a mesh.

    Every ``config.log_every_chunks`` chunks ``log(state, steps_run)``
    runs (default ``utils/logging.log_chunk``), and every
    ``config.checkpoint_every_chunks`` chunks with a ``checkpoint_path``
    ``save(state, steps_run)`` (default ``utils/checkpoint.save_state``
    of the state alone); both come after the stop and wall-clock checks, or
    before them with ``cadence_first`` (the hybrid's order, JAX
    models/hybrid.py:228-248). ``grow=False`` keeps the chunk length fixed.
    ``config.profile_dir`` traces the loop (:func:`profiled`).
    """

    def read_done(st):
        return sync.done(st.done) if sync is not None else st.done.cpu().numpy()

    def seconds(t):  # elapsed since t, the slowest rank's on a mesh
        s = time.perf_counter() - t
        return sync.max(s) if sync is not None else s

    if log is None:
        from odesat_tpu_torch.utils.logging import log_chunk as log
    if save is None:
        def save(st, n):
            from odesat_tpu_torch.utils.checkpoint import save_state

            save_state(config.checkpoint_path, st, n)

    def cadence(st, n, chunks):
        if config.log_every_chunks and chunks % config.log_every_chunks == 0:
            log(st, n)
        if (
            config.checkpoint_every_chunks
            and config.checkpoint_path
            and chunks % config.checkpoint_every_chunks == 0
        ):
            save(st, n)

    chunk_steps = chunk_steps if chunk_steps is not None else config.chunk_steps
    can_grow = grow and not config.wants_chunk_cadence()

    runner = make_runner(chunk_steps)
    tail_runner = None
    tail_n = None
    steps_run = steps_resumed
    chunks = 0
    t0 = time.perf_counter()
    with profiled(config.profile_dir):
        while True:
            remaining = None if budget is None else budget - steps_run
            if remaining is not None and remaining <= 0:
                break
            chunk_t0 = time.perf_counter()
            if remaining is not None and remaining < chunk_steps:
                # keyed on remaining: a multi-chunk runner may advance less
                # than its nominal n, shifting later tail sizes
                if tail_runner is None or tail_n != remaining:
                    tail_runner = make_runner(remaining)
                    tail_n = remaining
                state = tail_runner(state)
                nominal = remaining
            else:
                state = runner(state)
                nominal = chunk_steps
            # the host's decision after the slice: its done flags, growth, the
            # stop, the wall-clock budget and the cadence
            with span("loop.decide"):
                advanced = None
                if type(state) is tuple:  # NamedTuple states are excluded
                    state, advanced = state
                    advanced = int(advanced)
                    steps_run += advanced
                else:
                    steps_run += nominal
                chunks += 1
                done = read_done(state)  # waits for the chunk
                if can_grow and chunks % GROW_AFTER == 0 and chunk_steps < GROW_CAP:
                    bigger = min(chunk_steps * 16, GROW_CAP)
                    if budget is not None:
                        bigger = min(bigger, max(budget - steps_run, 1))
                    if config.wall_clock_budget_s is not None:
                        # the budget is only checked between chunks, so bound the
                        # grown chunk's predicted duration by the remaining seconds
                        last_chunk_s = seconds(chunk_t0)
                        remaining_s = config.wall_clock_budget_s - seconds(t0)
                        if last_chunk_s > 0 and remaining_s > 0:
                            cap = int(remaining_s * chunk_steps / last_chunk_s)
                            bigger = min(bigger, max(cap, 1))
                        elif remaining_s <= 0:
                            bigger = chunk_steps  # budget already spent
                    if bigger > chunk_steps:
                        runner = make_runner(bigger)
                        chunk_steps = bigger

                if cadence_first:
                    cadence(state, steps_run, chunks)
                if should_stop(state, done):
                    break
                # a multi-chunk runner advances 0 steps only from a state its
                # stop test already holds, which should_stop must see too:
                # otherwise this loop would spin without advancing
                if advanced == 0:
                    raise RuntimeError("a runner advanced 0 steps but should_stop did not fire")
                if (
                    config.wall_clock_budget_s is not None
                    and seconds(t0) > config.wall_clock_budget_s
                ):
                    break
                if not cadence_first:
                    cadence(state, steps_run, chunks)

    return state, steps_run, time.perf_counter() - t0
