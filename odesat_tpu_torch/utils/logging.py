"""Progress metrics and observability (the port of
``odesat_tpu.utils.logging``): per-chunk steps, solved counts and the dt
distribution, all read from the solver state."""

from __future__ import annotations

import logging
import sys

import numpy as np

logger = logging.getLogger("odesat_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(
        logging.Formatter("[%(asctime)s odesat_tpu_torch] %(message)s", "%H:%M:%S")
    )
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)


def chunk_metrics(state, steps_run: int) -> dict:
    """Summarize a solver state between chunks (copies only ``done`` and
    ``dt`` to the host)."""
    done = state.done.cpu().numpy()
    metrics = {"steps": steps_run, "solved": int(done.sum()), "batch": int(done.size)}
    if hasattr(state, "dt"):
        dt = state.dt.cpu().numpy()
        metrics.update(dt_min=float(dt.min()), dt_med=float(np.median(dt)), dt_max=float(dt.max()))
    return metrics


def log_chunk(state, steps_run: int) -> None:
    metrics = chunk_metrics(state, steps_run)
    parts = [f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()]
    logger.info(" ".join(parts))

