"""Timing helpers for the card.

PyTorch returns from a CUDA call before the device has finished, so a
host clock around an enqueue measures the enqueue. Device work is timed
with CUDA events, read after the stop event has completed. A host clock
around a run ends with :func:`sync`, a read of the ``done`` flags that
the run wrote (JAX utils/timing.py:18-34).
"""

from __future__ import annotations

import time

import numpy as np
import torch


def cuda_ms(fn, iters: int = 10, warmup: int = 1) -> float:
    """Milliseconds of device time per call of ``fn()``, from CUDA events
    around ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def sync(state) -> np.ndarray:
    """Wait for all pending work on ``state`` by reading its done flags to
    the host (on CUDA the copy waits for the stream), and return them."""
    return state.done.cpu().numpy()


def measure_throughput(runner, state, dev, chunk_steps: int, batch: int, iters: int = 3):
    """Steady-state trajectories*steps/s of ``runner(state, dev)``: one
    warm-up call (the build), then ``iters`` timed calls ending in a
    :func:`sync`. Returns (rate, final_state)."""
    state = runner(state, dev)
    sync(state)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = runner(state, dev)
    sync(state)
    elapsed = time.perf_counter() - t0
    return batch * chunk_steps * iters / elapsed, state
