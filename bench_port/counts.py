"""The yardstick of the kernels' roofline shares: the card's peaks and the
operations and bytes each kernel's work needs, counted from the formula's
shapes, whatever a kernel happens to read.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``nnz_of`` (``formulas.Layout.nnz``),
``table_bytes``, ``ode_step_ops``, ``ode_chunk_bound``, ``stoch_step_ops``
and ``stoch_chunk_bound`` (there at lines 1780-1842), restated on the
shapes (K, Mp, Np, nnz) so that they need no object of the program. A
later change to the program cannot move them.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM at its 700 W limit: HBM3 bandwidth,
# and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(nbytes: float, ops: float) -> tuple:
    """(seconds, "bytes" or "operations"): the least time the card could
    take, the larger of bytes over the memory rate and operations over the
    float32 rate, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def table_bytes(K: int, Mp: int, Np: int, nnz: int) -> int:
    """Literal codes, CSR pointers and occurrence lists, int32, read once."""
    return 4 * (K * Mp + Np + 1 + nnz)


def ode_step_ops(nnz: int, Np: int, Mp: int, fixed: bool) -> int:
    """Operations of one ODE step of one trajectory: per literal slot 3
    (its value, the running min and second min), per occurrence 12 (the
    contribution and its add), per variable 3 (the update and its clamp),
    per clause 10 (c, dxs, dxl, the clamped updates); the adaptive step is
    two RHS passes plus the trial states and the error."""
    f = 15 * nnz + 3 * Np + 10 * Mp
    return f if fixed else 2 * f + 6 * Np + 20 * Mp


def ode_chunk_bound(K: int, Mp: int, Np: int, nnz: int, B: int, steps: int,
                    fixed: bool) -> tuple:
    """B1 and B2 over one chunk of ``steps`` steps of B trajectories: the
    state (v, xs, xl, dt in float32, done) read and written once, the
    tables read once; operations for every step of every trajectory."""
    nbytes = 2 * B * (4 * (Np + 2 * Mp + 1) + 1) + table_bytes(K, Mp, Np, nnz)
    return bound(nbytes, B * steps * ode_step_ops(nnz, Np, Mp, fixed))


def stoch_step_ops(nnz: int, Np: int, Mp: int) -> int:
    """One stoch step of one chain: per literal slot 2 (its truth and the
    OR), per clause 3 (the weight update), per occurrence 3 (the weight
    and two adds), per variable 14 (the counter hash, the draw, the flip)."""
    return 5 * nnz + 3 * Mp + 14 * Np


def stoch_chunk_bound(K: int, Mp: int, Np: int, nnz: int, B: int, steps: int) -> tuple:
    """B3 and B4 over a chunk: v (bytes), xl (int32) and done read and
    written once, the tables once."""
    nbytes = 2 * B * (Np + 4 * Mp + 1) + table_bytes(K, Mp, Np, nnz)
    return bound(nbytes, B * steps * stoch_step_ops(nnz, Np, Mp))
