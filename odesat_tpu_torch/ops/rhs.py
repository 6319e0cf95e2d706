"""The memcomputing ODE right-hand side in plain torch: the port's twin of
``odesat_tpu.ops.rhs``.

It runs on any device and any float dtype, takes every formula (unit
clauses included), and is what the ``gather`` / ``segment_sum`` dv
strategies run: on the CPU, in float64, with a batch-shared adaptive dt,
and for formulas outside the chunk kernel's gate. Otherwise, on CUDA,
the main path goes through the chunk kernel (ops/fused_chunk.py).

Per clause m with literals (q_i, v_i):
  value_i = 1 - q_i * v_i                     (src/system.rs:49)
  C_m     = 0.5 * min_i value_i               (src/system.rs:60)
  g_{m,i} = 0.5 * q_i * (second_min at the argmin, min elsewhere)
  r_{m,i} = 0.5 * (q_i - v_i) gated by the rigidity mode
  dv_i   += xl_m*xs_m*g_{m,i} + (1+zeta*xl_m)*(1-xs_m)*r_{m,i}
  dxs_m   = BETA*(xs_m+EPS)*(C_m-GAMMA)
  dxl_m   = ALPHA*(C_m-DELTA)
  allsat  = AND_m (C_m < GAMMA)

``rigidity="paper"`` gates r on ``value_i == min``; ``"reference"`` on
``value_i == 0.5*min`` (the reference's exact-equality gate). Ties follow
the reference's running min / second-min scan: duplicated minima leave
second_min == min and every literal at the min takes second_min.
"""

from __future__ import annotations

import numpy as np
import torch

from odesat_tpu_torch.constants import ALPHA, BETA, DELTA, EPSILON, GAMMA

# Masked-literal sentinel. Must be +inf, not a large finite number: the
# reference's second-min for a unit clause is f64::INFINITY, so a unit
# clause's own literal receives an *infinite* gradient which the clamped
# Euler update then saturates to the corner. Padding slots are
# where-masked (never multiplied) so the inf cannot produce NaN.
_BIG = float("inf")


def clause_values(v, lit_var, sign, lit_mask):
    """Per-literal satisfaction degree ``1 - q_i v_i``; padded slots get
    +inf so they never win the min. Shapes: v (..., N), lit_var/sign/
    lit_mask (K, M) -> (..., K, M)."""
    gathered = v[..., lit_var]  # (..., K, M)
    vals = 1.0 - sign * gathered
    return torch.where(lit_mask > 0, vals, _BIG), gathered


def top2_min(vals):
    """(min, second-min-after-removing-one-instance) over the literal axis
    (axis=-2), matching the reference's scan semantics: duplicated minima
    leave second_min == min."""
    min1 = vals.amin(dim=-2, keepdim=True)  # (..., 1, M)
    amin = vals.argmin(dim=-2, keepdim=True)  # first occurrence
    k_idx = torch.arange(vals.shape[-2], device=vals.device).view(-1, 1)
    vals_wo = torch.where(k_idx == amin, _BIG, vals)
    min2 = vals_wo.amin(dim=-2, keepdim=True)
    return min1, min2


def accumulate_dv_gather(contrib_flat, var_occ, occ_mask):
    """dv via variable-major gather+sum: contrib_flat (..., K*M),
    var_occ/occ_mask (N, D) -> (..., N). Deterministic: no atomics."""
    picked = contrib_flat[..., var_occ]  # (..., N, D)
    return (picked * occ_mask).sum(dim=-1)


def segment_table(seg_ids: np.ndarray, n_segments: int, device) -> tuple:
    """The tables of :func:`segment_sum_sorted` for entries that go to
    segments ``seg_ids``: ``(order, offsets)`` on ``device``, int64. ``order``
    lists the entries by segment, each segment's in index order (a stable
    sort); ``offsets`` (n_segments + 1) is where each segment starts in it."""
    seg_ids = np.asarray(seg_ids, dtype=np.int64).reshape(-1)
    order = np.argsort(seg_ids, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(seg_ids, minlength=n_segments))])
    return torch.as_tensor(order, device=device), torch.as_tensor(offsets, device=device)


def segment_sum_sorted(x, table):
    """``x`` (..., S) summed into the segments of :func:`segment_table`'s
    ``table`` -> (..., n_segments): the entries gathered in segment order,
    then ``torch.segment_reduce`` adds each segment's entries one after
    another, in index order. No float atomics, so a run repeats its bits;
    an empty segment sums to 0. ``unsafe=True`` skips the checks of the
    offsets, which read back to the host."""
    order, offsets = table
    rows = x.reshape(-1, x.shape[-1])
    out = torch.segment_reduce(rows[:, order], "sum", axis=1, unsafe=True,
                               offsets=offsets.expand(rows.shape[0], -1))
    return out.reshape(*x.shape[:-1], offsets.numel() - 1)


def accumulate_dv_segment(contrib_flat, lit_var_flat, n_vars_padded, table=None):
    """dv by segment over the flat literal slots. On the CPU one
    ``index_add_``, which adds in index order there and is faster than the
    sorted sum. On CUDA, where ``index_add_`` adds with float atomics in an
    order that changes from run to run, :func:`segment_sum_sorted` over
    ``table`` (built here from ``lit_var_flat`` when not given: a read to the
    host and a sort, each call)."""
    if contrib_flat.device.type == "cpu":
        out = contrib_flat.new_zeros(*contrib_flat.shape[:-1], n_vars_padded)
        return out.index_add_(-1, lit_var_flat, contrib_flat)
    if table is None:
        table = segment_table(lit_var_flat.cpu().numpy(), n_vars_padded, contrib_flat.device)
    return segment_sum_sorted(contrib_flat, table)


def _clause_terms(v, xs, xl, lit_var, sign, lit_mask, clause_mask, zeta, rigidity):
    """Per-clause math for one width bucket: returns (c, contrib_flat)
    where contrib_flat is the flattened (..., K*M) per-literal dv
    contribution in row-major (k, m) order."""
    vals, gathered = clause_values(v, lit_var, sign, lit_mask)  # (..., K, M)
    min1, min2 = top2_min(vals)
    c = 0.5 * min1.squeeze(-2)  # (..., M)
    c = torch.where(clause_mask > 0, c, 0.0)

    lit_on = lit_mask > 0
    is_min = vals <= min1  # exact: min1 is one of the vals
    # where-masked (not multiplied): g can be +-inf for a unit clause's
    # own literal and 0*inf would poison padding with NaN
    g = torch.where(lit_on, 0.5 * sign * torch.where(is_min, min2, min1), 0.0)

    if rigidity == "paper":
        r_gate = is_min
    elif rigidity == "reference":
        # C_m == value_i  <=>  0.5*min == value_i (src/system.rs:73)
        r_gate = vals == (0.5 * min1)
    else:
        raise ValueError(f"unknown rigidity mode: {rigidity!r}")
    r = torch.where(r_gate & lit_on, 0.5 * (sign - gathered), 0.0)

    xs_b = xs.unsqueeze(-2)  # (..., 1, M)
    xl_b = xl.unsqueeze(-2)
    contrib = torch.where(
        lit_on, xl_b * xs_b * g + (1.0 + zeta * xl_b) * (1.0 - xs_b) * r, 0.0
    )
    K, M = lit_var.shape
    return c, contrib.reshape(*contrib.shape[:-2], K * M)


def compute_derivatives(
    v,
    xs,
    xl,
    *,
    lit_var,
    sign,
    lit_mask,
    clause_mask,
    var_occ,
    occ_mask,
    zeta,
    rigidity: str = "paper",
    dv_strategy: str = "gather",
    bucket_slices=None,
    segment_table=None,
):
    """One RHS evaluation over a leading batch axis. Returns
    (dv, dxs, dxl, allsat).

    v: (..., N) variable values; xs, xl: (..., M) clause memories; the
    formula tensors as in ``cnf.arrays.FormulaArrays`` (``lit_var`` and
    ``var_occ`` int64 for indexing), on the same device as the state.

    ``bucket_slices``: static tuple of (m0, m1, K_b) width buckets over a
    clause axis pre-sorted by width; each bucket's clause math runs at its
    own literal width K_b. None = one bucket at full width. ``var_occ``
    must index the matching flattened contribution layout (the compiler
    builds both consistently). ``segment_table``: ``segment_sum``'s tables
    on CUDA (:func:`segment_table` over the flat slots' variables, in bucket
    order), built ahead so that the pass reads nothing back to the host.
    """
    K, M = lit_var.shape
    if bucket_slices is None:
        bucket_slices = ((0, M, K),)

    c_parts = []
    contrib_parts = []
    seg_parts = []
    for m0, m1, Kb in bucket_slices:
        c_b, contrib_b = _clause_terms(
            v,
            xs[..., m0:m1],
            xl[..., m0:m1],
            lit_var[:Kb, m0:m1],
            sign[:Kb, m0:m1],
            lit_mask[:Kb, m0:m1],
            clause_mask[m0:m1],
            zeta,
            rigidity,
        )
        c_parts.append(c_b)
        contrib_parts.append(contrib_b)
        seg_parts.append(lit_var[:Kb, m0:m1].reshape(-1))

    c = c_parts[0] if len(c_parts) == 1 else torch.cat(c_parts, dim=-1)
    contrib_flat = (
        contrib_parts[0] if len(contrib_parts) == 1 else torch.cat(contrib_parts, dim=-1)
    )

    if dv_strategy == "gather":
        dv = accumulate_dv_gather(contrib_flat, var_occ, occ_mask)
    elif dv_strategy == "segment_sum":
        seg_ids = seg_parts[0] if len(seg_parts) == 1 else torch.cat(seg_parts)
        dv = accumulate_dv_segment(contrib_flat, seg_ids, v.shape[-1], segment_table)
    else:
        raise ValueError(f"unknown dv_strategy: {dv_strategy!r}")

    dxs = BETA * (xs + EPSILON) * (c - GAMMA) * clause_mask
    dxl = ALPHA * (c - DELTA) * clause_mask
    allsat = ((c < GAMMA) | (clause_mask <= 0)).all(dim=-1)
    return dv, dxs, dxl, allsat
