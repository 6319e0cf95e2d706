"""Timing helpers for the card.

PyTorch returns from a CUDA call before the device has finished, so a
host clock around an enqueue measures the enqueue. Device work is timed
with CUDA events, read after the stop event has completed.
"""

from __future__ import annotations

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
