"""Formula -> padded incidence arrays: the device representation.

A copy of ``odesat_tpu.cnf.arrays`` that the port owns, so that it never
imports jax (``odesat_tpu/__init__.py`` imports its jax models eagerly).
The arrays are array-equal to the JAX package's compile
(tests/test_torch_cnf.py). The layout was chosen for the TPU and is kept
so both packages see the same formula:

* ``lit_var/sign/lit_mask  : (K, M)`` -- clause-major; used to gather
  variable values and compute per-literal clause terms;
* ``var_occ/occ_mask       : (N, D)`` -- variable-major (transposed
  incidence, D = max occurrences); used to accumulate per-variable
  derivative contributions as a gather + sum instead of a scatter.

The CUDA chunk kernel builds its own compact tables from ``lit_var`` and
``lit_mask`` (ops/fused_chunk.py); the torch twin reads these directly.

Padded literal slots carry ``sign == 0`` and point at variable 0; padded
clause rows are masked out of the satisfaction flag and memory dynamics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from odesat_tpu_torch.cnf.formula import CNFFormula


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple if x else multiple


@dataclass(frozen=True)
class FormulaArrays:
    """Static device-ready encoding of a CNF formula.

    Shapes: ``lit_var/sign/lit_mask: (K, M)``, ``clause_mask/xs_init: (M,)``,
    ``var_occ/occ_sign/occ_mask: (N, D)`` with ``var_occ`` flat indices into
    the row-major flattened ``(K*M,)`` contribution array.
    """

    lit_var: np.ndarray
    sign: np.ndarray
    lit_mask: np.ndarray
    clause_mask: np.ndarray
    xs_init: np.ndarray
    var_occ: np.ndarray
    occ_mask: np.ndarray
    n_vars: int  # declared varnum (state vector logical length)
    n_vars_padded: int
    n_clauses: int  # real clause count (xl clamp uses this)
    n_clauses_padded: int
    max_width: int
    min_width: int  # unit clauses (width 1) produce infinite gradients
    max_occ: int
    density: float
    # static width buckets over a clause axis pre-sorted by width:
    # ((m0, m1, K_b), ...) — each bucket's RHS runs at its own literal
    # width so mixed-width formulas don't pay max width per clause.
    # Single full-width bucket when bucketing is off.
    bucket_slices: tuple = ()
    n_slots: int = 0  # total flattened contribution slots sum(K_b * M_b)
    # the clause-sharded compile's per-shard tables (ops/shard_stream.py
    # ShardPlan); None for every other layout
    shard_plan: object = None

    def __repr__(self) -> str:  # compact — the arrays are large
        return (
            f"FormulaArrays(n_vars={self.n_vars}/{self.n_vars_padded}, "
            f"n_clauses={self.n_clauses}/{self.n_clauses_padded}, "
            f"K={self.max_width}, D={self.max_occ}, density={self.density:.3f})"
        )


def _make_buckets(widths, min_bucket: int):
    """Group clause indices (pre-sorted by width) into width buckets.
    Greedy: accumulate ascending widths until a bucket holds at least
    ``min_bucket`` clauses, then close it at the next width change.
    Returns a list of lists of clause indices."""
    order = sorted(range(len(widths)), key=lambda i: (widths[i], i))
    buckets = []
    current = []
    current_width = None
    for idx in order:
        w = widths[idx]
        if current and w != current_width and len(current) >= min_bucket:
            buckets.append(current)
            current = []
        current.append(idx)
        current_width = w
    if current:
        buckets.append(current)
    return buckets


def slot_clause_map(fa: "FormulaArrays") -> np.ndarray:
    """Map each flat contribution slot — the layout ``var_occ`` indexes:
    concatenated per-bucket ``(K_b, M_b)`` blocks (see the occurrence
    construction in :func:`compile_formula`) — to its clause column.
    ``slot_clause_map(fa)[fa.var_occ]`` therefore gives, per variable
    occurrence, the clause that occurrence lives in, valid for both
    layouts (single-bucket and width-bucketed)."""
    bucket_slices = fa.bucket_slices or ((0, fa.n_clauses_padded, fa.max_width),)
    out = np.zeros((max(fa.n_slots, 1),), dtype=np.int32)
    off = 0
    for m0, m1, Kb in bucket_slices:
        Mb = m1 - m0
        cols = np.arange(m0, m1, dtype=np.int32)
        for k in range(Kb):
            out[off + k * Mb : off + (k + 1) * Mb] = cols
        off += Kb * Mb
    return out


def compile_formula(
    formula: CNFFormula,
    *,
    dtype=np.float32,
    clause_pad: int = 128,
    var_pad: int = 128,
    bucket: bool = False,
    min_bucket: int = 256,
    window_sort: bool = False,
) -> FormulaArrays:
    """Compile a normalized formula (variables must be dense indices
    ``0..k-1``; see :func:`normalize_cnf_variables`) into padded arrays.

    ``xs_init`` encodes the reference's short-term-memory initialization:
    +1 if the clause contains a negated literal else -1 -- "the clause's
    value if all variables are 0" (reference: src/system.rs:362-372).

    ``bucket=True`` sorts the clause axis by width and records static
    width buckets so the RHS runs each bucket at its own literal width
    (big win after preprocessing, which emits wide resolvents). Clause
    order is an internal layout choice: the dynamics and the readout are
    clause-permutation invariant (up to float summation order).
    """
    if any(len(c) == 0 for c in formula.clauses):
        raise ValueError("formula contains an empty clause (trivially UNSAT)")

    M = formula.num_clauses
    K = max(formula.max_clause_width, 1)
    N = formula.varnum
    used = formula.variable_set()
    if used and (min(used) < 0 or max(used) >= N):
        raise ValueError("formula is not normalized: variables must lie in [0, varnum)")

    widths = [len(c) for c in formula.clauses]
    if bucket and M and len(set(widths)) > 1:
        index_buckets = _make_buckets(widths, min_bucket)
    else:
        index_buckets = [list(range(M))]

    if window_sort:
        # order clauses inside each bucket by their lowest variable so
        # consecutive clause spans touch a narrow variable window — the
        # streaming kernel's per-span windows shrink accordingly on
        # locally-structured instances (encoder-numbered variables).
        # Clause order is an internal layout choice (see docstring).
        index_buckets = [
            sorted(ix, key=lambda i: min(l.variable for l in formula.clauses[i]))
            for ix in index_buckets
        ]

    # lay out each bucket as a padded slice of the clause axis
    bucket_meta = []  # (m0, m1, K_b, clause_indices)
    cursor = 0
    for indices in index_buckets:
        Kb = max((widths[i] for i in indices), default=1)
        Mb = _round_up(len(indices), clause_pad)
        bucket_meta.append((cursor, cursor + Mb, Kb, indices))
        cursor += Mb
    Mp = cursor
    Np = _round_up(N, var_pad)

    lit_var = np.zeros((K, Mp), dtype=np.int32)
    sign = np.zeros((K, Mp), dtype=dtype)
    lit_mask = np.zeros((K, Mp), dtype=dtype)
    clause_mask = np.zeros((Mp,), dtype=dtype)
    xs_init = np.full((Mp,), 1.0, dtype=dtype)

    occurrences = [[] for _ in range(Np)]  # var -> flat contribution slot
    slot_offset = 0
    for m0, m1, Kb, indices in bucket_meta:
        Mb = m1 - m0
        for j, ci in enumerate(indices):
            m = m0 + j
            clause = formula.clauses[ci]
            clause_mask[m] = 1.0
            xs_init[m] = 1.0 if any(lit.is_negated for lit in clause) else -1.0
            for k, lit in enumerate(clause):
                lit_var[k, m] = lit.variable
                sign[k, m] = -1.0 if lit.is_negated else 1.0
                lit_mask[k, m] = 1.0
                # slot in the concatenated per-bucket (K_b, M_b) layout
                occurrences[lit.variable].append(slot_offset + k * Mb + j)
        slot_offset += Kb * Mb
    n_slots = slot_offset

    D = max((len(o) for o in occurrences), default=1) or 1
    var_occ = np.zeros((Np, D), dtype=np.int32)
    occ_mask = np.zeros((Np, D), dtype=dtype)
    for i, occ in enumerate(occurrences):
        if occ:
            var_occ[i, : len(occ)] = occ
            occ_mask[i, : len(occ)] = 1.0

    return FormulaArrays(
        lit_var=lit_var,
        sign=sign,
        lit_mask=lit_mask,
        clause_mask=clause_mask,
        xs_init=xs_init,
        var_occ=var_occ,
        occ_mask=occ_mask,
        n_vars=N,
        n_vars_padded=Np,
        n_clauses=M,
        n_clauses_padded=Mp,
        max_width=K,
        min_width=min(widths, default=1),
        max_occ=D,
        density=formula.clause_density(),
        bucket_slices=tuple((m0, m1, Kb) for m0, m1, Kb, _ in bucket_meta),
        n_slots=n_slots,
    )
