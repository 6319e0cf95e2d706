"""The benchmark's formulas: its DIMACS reader, its seeded generator of
planted random k-SAT, its oracle, and the compiled layout its plain
reference integrates.

These are frozen copies, kept here so that no change to the program can
move the yardstick, and they import nothing of the program:

* :func:`read_dimacs` copies ``odesat_tpu_torch/cnf/dimacs.py``'s
  ``parse_dimacs`` rules (comments and blank lines skipped, a ``%`` line
  ends the file, a clause is one line ended by ``0``) and
  :func:`normalized` its ``normalize_cnf_variables`` (the used variables,
  sorted, renamed to ``0..k-1``; the declared count kept).
* :func:`planted_ksat` draws from the distribution of
  ``odesat_tpu_torch/utils/generate.py``'s ``random_ksat(planted=True)``
  (``uf_instance``): a hidden assignment, then per clause k distinct
  variables and independent polarities, redrawn until the clause agrees
  with the hidden assignment. It draws whole instances with array
  operations, so a pool of thousands costs a fraction of a second.
* :func:`layout` works out again what the program's set-up derives from a
  formula: ``cnf/arrays.py``'s ``compile_formula`` with the settings the
  CLI uses (128-padding, clauses in one width bucket ordered by their
  lowest variable) and ``ops/fused_chunk.py``'s ``chunk_tables`` (each
  variable's occurrences in clause, then slot, order), and the learning
  rate of ``utils/config.py``'s density table.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

PAD = 128  # the CLI's var_pad and clause_pad
BUCKET_MIN_CLAUSES = 512  # compile_for_config's "auto": buckets from this many clauses
XL_CAP_PER_CLAUSE = 1e4


class Formula(NamedTuple):
    """A CNF formula over variables ``0..varnum-1``: ``var`` (m, K) int32
    and ``neg`` (m, K) bool, a clause a row, its literals in their order;
    ``var`` is -1 past a clause's width."""

    var: np.ndarray
    neg: np.ndarray
    varnum: int

    @property
    def widths(self) -> np.ndarray:
        return (self.var >= 0).sum(axis=1)


def read_dimacs(text: str) -> Formula:
    """DIMACS text as written (variables as named there, ``var`` holding
    the names); :func:`normalized` renames them."""
    clauses, varnum = [], None
    for line in text.splitlines():
        s = line.strip()
        if not s or s.startswith("c"):
            continue
        if s == "%":
            break
        if s.startswith("p"):
            parts = s.split()
            if len(parts) < 3 or parts[1] != "cnf":
                raise ValueError(f"malformed problem line: {line!r}")
            varnum = int(parts[2])
            continue
        lits = []
        for tok in s.split():
            if tok == "0":
                break
            lits.append(int(tok))
        if lits:
            clauses.append(lits)
    if not clauses:
        raise ValueError("no clauses")
    K = max(len(c) for c in clauses)
    var = np.full((len(clauses), K), -1, dtype=np.int32)
    neg = np.zeros((len(clauses), K), dtype=bool)
    for i, c in enumerate(clauses):
        var[i, : len(c)] = np.abs(c)
        neg[i, : len(c)] = np.asarray(c) < 0
    if varnum is None:
        varnum = len(np.unique(var[var >= 0]))
    return Formula(var, neg, varnum)


def normalized(f: Formula) -> Formula:
    """The used variables, sorted, renamed to ``0..k-1``; the declared
    ``varnum`` is kept."""
    used = np.unique(f.var[f.var >= 0])
    var = np.where(f.var >= 0, np.searchsorted(used, np.maximum(f.var, 0)), -1)
    return Formula(var.astype(np.int32), f.neg, f.varnum)


def planted_ksat(rng: np.random.Generator, count: int, n: int, m: int, k: int = 3) -> Formula:
    """``count`` planted random k-SAT instances of n variables and m
    clauses, stacked: ``var``/``neg`` of shape (count, m, k)."""
    hidden = rng.integers(0, 2, size=(count, n)).astype(bool)
    var = rng.integers(0, n, size=(count * m, k), dtype=np.int32)
    redo = np.arange(count * m)
    while redo.size:  # k distinct variables a clause
        s = np.sort(var[redo], axis=1)
        redo = redo[(s[:, 1:] == s[:, :-1]).any(axis=1)]
        var[redo] = rng.integers(0, n, size=(redo.size, k), dtype=np.int32)
    neg = rng.integers(0, 2, size=(count * m, k)).astype(bool)
    owner = np.repeat(np.arange(count), m)
    redo = np.arange(count * m)
    while True:  # every clause agrees with the hidden assignment somewhere
        redo = redo[~(hidden[owner[redo, None], var[redo]] != neg[redo]).any(axis=1)]
        if not redo.size:
            break
        neg[redo] = rng.integers(0, 2, size=(redo.size, k)).astype(bool)
    return Formula(var.reshape(count, m, k), neg.reshape(count, m, k), n)


def satisfied(f: Formula, assignment: np.ndarray) -> np.ndarray:
    """The oracle: for each row of ``assignment`` ((rows, >= varnum) bool,
    True = the variable is true), whether it satisfies every clause."""
    a = np.asarray(assignment, dtype=bool)
    on = f.var >= 0
    lit = a[:, np.maximum(f.var, 0)] != f.neg  # (rows, m, K)
    return (lit & on).any(axis=2).all(axis=1)


def zeta_for_density(density: float) -> float:
    if density >= 6.0:
        return 0.1
    if density >= 4.9:
        return 0.01
    return 0.001


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple if x else multiple


class Layout(NamedTuple):
    """A formula as the program's set-up lays it out for B1: ``lit_var``,
    ``negated``, ``lit_on`` (K, Mp); ``occ`` (Np, D), each variable's flat
    slots ``k*Mp + m`` in (clause, slot) order, padded with ``K*Mp`` (a
    slot that holds 0); ``xs_init`` and ``clause_on`` (Mp,)."""

    lit_var: np.ndarray
    negated: np.ndarray
    lit_on: np.ndarray
    occ: np.ndarray
    xs_init: np.ndarray
    clause_on: np.ndarray
    n_vars: int
    n_clauses: int
    Np: int
    Mp: int
    K: int
    nnz: int
    zeta: float
    xl_cap: float


def layout(f: Formula) -> Layout:
    """The program's compiled layout of ``f`` (normalized), worked out
    again. A formula of mixed widths and at least 512 clauses, which the
    program would split into width buckets, is refused."""
    m, K = f.var.shape
    widths = f.widths
    if m >= BUCKET_MIN_CLAUSES and widths.min() != widths.max():
        raise NotImplementedError("width-bucketed layouts are not laid out by the reference")
    minvar = np.where(f.var >= 0, f.var, np.iinfo(np.int32).max).min(axis=1)
    order = np.argsort(minvar, kind="stable")  # Python's sorted(key=...) is stable too
    Mp, Np = _round_up(m, PAD), _round_up(f.varnum, PAD)
    lit_var = np.zeros((K, Mp), dtype=np.int64)
    negated = np.zeros((K, Mp), dtype=bool)
    lit_on = np.zeros((K, Mp), dtype=bool)
    on = f.var[order] >= 0
    lit_var[:, :m] = np.where(on, f.var[order], 0).T
    negated[:, :m] = (f.neg[order] & on).T
    lit_on[:, :m] = on.T
    xs_init = np.ones(Mp, dtype=np.float32)
    xs_init[:m] = np.where((f.neg[order] & on).any(axis=1), 1.0, -1.0)
    clause_on = np.zeros(Mp, dtype=bool)
    clause_on[:m] = True
    ks, ms = np.nonzero(lit_on)
    var = lit_var[ks, ms]
    pick = np.lexsort((ks, ms, var))  # by variable, then clause, then slot
    slots = (ks * Mp + ms)[pick]
    counts = np.bincount(var, minlength=Np)
    D = max(int(counts.max()), 1)
    occ = np.full((Np, D), K * Mp, dtype=np.int64)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(slots.size) - start[var[pick]]
    occ[var[pick], rank] = slots
    return Layout(lit_var, negated, lit_on, occ, xs_init, clause_on, f.varnum, m, Np, Mp, K,
                  int(ks.size), zeta_for_density(m / f.varnum), XL_CAP_PER_CLAUSE * m)
