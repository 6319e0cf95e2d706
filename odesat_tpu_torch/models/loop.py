"""The chunked host loop (the port of ``odesat_tpu.models.loop``).

The ODE loop dispatches chunks of steps and checks exit conditions on the
host between chunks: step budget and tail chunks, multiplicative chunk
escalation, wall-clock budget and log cadence live here once, with the
same arithmetic as the JAX package, so ``steps_run`` is the same number
for the same config.

Escalation: every chunk boundary costs a host round trip, so after every
GROW_AFTER further chunks without stopping the chunk grows 16x up to
GROW_CAP; long runs approach the kernel's rate while fast solves keep the
fine early-exit window. Log cadence disables growth so the interval stays
what the user asked for.
"""

from __future__ import annotations

import time

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


def run_chunks(chunk, chunk_steps: int, max_chunks: int, stop_all: bool = False):
    """``run(state) -> (state, steps_advanced)`` running up to
    ``max_chunks`` calls of ``chunk(state) -> state`` of ``chunk_steps``
    steps each, stopping after the first that leaves any (or, with
    ``stop_all``, every) row done. The JAX package runs this loop on the
    device; here it is a host loop with one ``done`` read per chunk, which
    keeps the same early-exit window and an exact ``steps_advanced``."""

    def run(state):
        n = 0
        while n < max_chunks:
            state = chunk(state)
            n += 1
            if bool(state.done.all() if stop_all else state.done.any()):
                break
        return state, n * chunk_steps

    return run


def drive_chunks(
    state,
    make_runner,
    config,
    budget,
    should_stop,
    steps_resumed: int = 0,
    chunk_steps: int | None = None,
):
    """Run ``state = runner(state)`` chunks until ``should_stop(state,
    done)`` (done arrives as a host numpy array), the step budget, or the
    wall-clock budget. ``make_runner(n) -> (state -> state)`` builds a
    runner advancing every trajectory n steps; a runner may instead return
    ``(state, steps_advanced)`` when it stops early (models/ode.
    make_multi_chunk_runner), and the actual advance is then credited
    instead of the nominal n. Returns ``(state, steps_run, wall_time_s)``.
    """
    chunk_steps = chunk_steps if chunk_steps is not None else config.chunk_steps
    can_grow = not config.wants_chunk_cadence()

    runner = make_runner(chunk_steps)
    tail_runner = None
    tail_n = None
    steps_run = steps_resumed
    chunks = 0
    t0 = time.perf_counter()
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
        if type(state) is tuple:  # NamedTuple states are excluded
            state, advanced = state
            steps_run += int(advanced)
        else:
            steps_run += nominal
        chunks += 1
        done = state.done.cpu().numpy()  # waits for the chunk
        if can_grow and chunks % GROW_AFTER == 0 and chunk_steps < GROW_CAP:
            bigger = min(chunk_steps * 16, GROW_CAP)
            if budget is not None:
                bigger = min(bigger, max(budget - steps_run, 1))
            if config.wall_clock_budget_s is not None:
                # the budget is only checked between chunks, so bound the
                # grown chunk's predicted duration by the remaining seconds
                last_chunk_s = time.perf_counter() - chunk_t0
                remaining_s = config.wall_clock_budget_s - (time.perf_counter() - t0)
                if last_chunk_s > 0 and remaining_s > 0:
                    cap = int(remaining_s * chunk_steps / last_chunk_s)
                    bigger = min(bigger, max(cap, 1))
                elif remaining_s <= 0:
                    bigger = chunk_steps  # budget already spent
            if bigger > chunk_steps:
                runner = make_runner(bigger)
                chunk_steps = bigger

        if should_stop(state, done):
            break
        if (
            config.wall_clock_budget_s is not None
            and time.perf_counter() - t0 > config.wall_clock_budget_s
        ):
            break
        if config.log_every_chunks and chunks % config.log_every_chunks == 0:
            from odesat_tpu_torch.utils.logging import log_chunk

            log_chunk(state, steps_run)

    return state, steps_run, time.perf_counter() - t0
