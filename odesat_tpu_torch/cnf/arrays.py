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

The compile runs on every solve, with the card idle, so it touches the
Python clause objects once: one flat read of every literal into NumPy
arrays, then whole-array operations (index arithmetic, one scatter a
table, one sort for the occurrence table), with no Python loop over the
clauses or literals (see :func:`compile_formula`).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import chain

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


def _bucket_order(widths: np.ndarray, min_bucket: int):
    """The clause indices sorted by width (stable) and the sizes of the
    width buckets that split them. Greedy: accumulate ascending widths
    until a bucket holds at least ``min_bucket`` clauses, then close it at
    the next width change."""
    order = np.argsort(widths, kind="stable")
    sizes, size = [], 0
    for count in np.unique(widths, return_counts=True)[1].tolist():
        if size and size >= min_bucket:
            sizes.append(size)
            size = 0
        size += count
    if size:
        sizes.append(size)
    return order, sizes


def _make_buckets(widths, min_bucket: int):
    """Group clause indices (pre-sorted by width) into width buckets by
    :func:`_bucket_order`'s rule. Returns a list of lists of clause
    indices."""
    order, sizes = _bucket_order(np.asarray(widths, dtype=np.int64), min_bucket)
    return [ix.tolist() for ix in np.split(order, np.cumsum(sizes)[:-1])] if sizes else []


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

    How it is built: the clause widths and every literal's variable and
    negation are read once (``np.fromiter``). The clause order comes from a
    stable sort by width (the buckets) and, with ``window_sort``, a stable
    sort of each bucket by its clauses' lowest variable; each literal's
    column ``m``, slot ``k`` and contribution slot follow from cumulative
    widths, and the clause-major tables are one fancy-index assignment
    each. The occurrence table orders the literals by ``(variable, m, k)``,
    the order of a walk over the laid-out clauses, in one sort, and places
    each at its column within its variable's row by a cumulative count.
    """
    clauses = formula.clauses
    M = len(clauses)
    N = formula.varnum
    widths = np.fromiter(map(len, clauses), dtype=np.int64, count=M)
    if M and not widths.min():
        raise ValueError("formula contains an empty clause (trivially UNSAT)")
    K = max(int(widths.max()) if M else 0, 1)
    L = int(widths.sum())
    # every literal once: a Literal is a (variable, is_negated) pair
    flat = np.fromiter(chain.from_iterable(chain.from_iterable(clauses)), dtype=np.int64,
                       count=2 * L).reshape(L, 2)
    var, neg = flat[:, 0], flat[:, 1].astype(bool)
    if L and (var.min() < 0 or var.max() >= N):
        raise ValueError("formula is not normalized: variables must lie in [0, varnum)")
    starts = np.cumsum(widths) - widths  # each clause's first literal

    if bucket and M and widths.min() != widths.max():
        order, sizes = _bucket_order(widths, min_bucket)
        index_buckets = np.split(order, np.cumsum(sizes)[:-1])
    else:
        index_buckets = [np.arange(M)]

    if window_sort and M:
        # order clauses inside each bucket by their lowest variable so
        # consecutive clause spans touch a narrow variable window — the
        # streaming kernel's per-span windows shrink accordingly on
        # locally-structured instances (encoder-numbered variables).
        # Clause order is an internal layout choice (see docstring). The
        # sort is stable: ties keep their order in the bucket.
        low = np.minimum.reduceat(var, starts)
        index_buckets = [ix[np.argsort(low[ix], kind="stable")] for ix in index_buckets]

    # lay out each bucket as a padded slice of the clause axis: per clause
    # its column m, its bucket's padded length Mb and the bucket's first
    # slot in the concatenated per-bucket (K_b, M_b) contribution layout
    bucket_slices = []
    m_of = np.zeros((M,), dtype=np.int64)
    mb_of = np.zeros((M,), dtype=np.int64)
    slot0_of = np.zeros((M,), dtype=np.int64)
    cursor = n_slots = 0
    for ix in index_buckets:
        Kb = int(widths[ix].max()) if len(ix) else 1
        Mb = _round_up(len(ix), clause_pad)
        m_of[ix] = np.arange(cursor, cursor + len(ix))
        mb_of[ix] = Mb
        slot0_of[ix] = n_slots - cursor  # + k * Mb + m gives the slot
        bucket_slices.append((cursor, cursor + Mb, Kb))
        cursor += Mb
        n_slots += Kb * Mb
    Mp = cursor
    Np = _round_up(N, var_pad)

    # per literal: its clause, its slot k in the clause, its column m
    clause = np.repeat(np.arange(M), widths)
    k = np.arange(L) - starts[clause]
    m = m_of[clause]
    slot = slot0_of[clause] + k * mb_of[clause] + m

    lit_var = np.zeros((K, Mp), dtype=np.int32)
    sign = np.zeros((K, Mp), dtype=dtype)
    lit_mask = np.zeros((K, Mp), dtype=dtype)
    clause_mask = np.zeros((Mp,), dtype=dtype)
    xs_init = np.full((Mp,), 1.0, dtype=dtype)
    lit_var[k, m] = var
    sign[k, m] = np.where(neg, -1.0, 1.0)
    lit_mask[k, m] = 1.0
    clause_mask[m_of] = 1.0
    if M:
        xs_init[m_of] = np.where(np.logical_or.reduceat(neg, starts), 1.0, -1.0)

    # variable-major occurrences, each variable's in the order of (m, k):
    # one sort on a key unique to each literal
    by_var = np.argsort((var * Mp + m) * K + k)
    counts = np.bincount(var, minlength=Np)
    D = int(counts.max()) or 1
    var_sorted = var[by_var]
    col = np.arange(L) - (np.cumsum(counts) - counts)[var_sorted]
    var_occ = np.zeros((Np, D), dtype=np.int32)
    occ_mask = np.zeros((Np, D), dtype=dtype)
    var_occ[var_sorted, col] = slot[by_var]
    occ_mask[var_sorted, col] = 1.0

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
        min_width=int(widths.min()) if M else 1,
        max_occ=D,
        density=formula.clause_density(),
        bucket_slices=tuple(bucket_slices),
        n_slots=n_slots,
    )
