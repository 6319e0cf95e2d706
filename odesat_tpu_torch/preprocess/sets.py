"""Set-form CNF used by the preprocessor.

The reference uses ``BTreeSet<Literal>`` clauses inside a
``BTreeSet<CNFClauseSet>`` formula (reference: src/cnf.rs:317-416);
here a clause is a ``frozenset[Literal]`` and the formula holds a plain
``set`` of them plus ``varnum``. Conversion back to the ordered form
sorts literals by (variable, is_negated) and clauses lexicographically,
matching the Rust BTreeSet iteration order (derived ``Ord`` on
``Literal {variable, is_negated}``), so clause ordering — and therefore
clause-indexed device arrays — is deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from odesat_tpu_torch.cnf.formula import CNFFormula, Literal


@dataclass
class CNFFormulaSet:
    clauses: set = field(default_factory=set)  # set[frozenset[Literal]]
    varnum: int = 0

    def density(self) -> float:
        return len(self.clauses) / self.varnum if self.varnum else float("inf")


def to_formula_set(formula: CNFFormula) -> CNFFormulaSet:
    """CNFFormula -> set form; duplicate clauses and duplicate literals
    collapse (reference: src/cnf.rs:381-394)."""
    return CNFFormulaSet({frozenset(clause) for clause in formula.clauses}, formula.varnum)


def _clause_sort_key(clause: frozenset):
    return tuple(sorted((lit.variable, lit.is_negated) for lit in clause))


def from_formula_set(formula_set: CNFFormulaSet) -> CNFFormula:
    """Set form -> ordered CNFFormula in BTreeSet order
    (reference: src/cnf.rs:397-416)."""
    clauses = [
        tuple(Literal(v, n) for v, n in _clause_sort_key(clause))
        for clause in sorted(formula_set.clauses, key=_clause_sort_key)
    ]
    return CNFFormula(clauses, formula_set.varnum)


def is_tautology(clause: frozenset) -> bool:
    """A clause containing x and ¬x (reference: src/cnf.rs:541-551)."""
    return any(Literal(lit.variable, not lit.is_negated) in clause for lit in clause)


def subsume_clauses(clauses: set) -> None:
    """Remove every clause that is a proper superset of another
    (reference: src/cnf.rs:521-539). In-place.

    Occurrence-indexed: a subsuming clause contains only literals of the
    subsumed one, so it appears in the occurrence list of at least one
    of them — same final set as the reference's all-pairs scan at
    Sum |occ| cost instead of O(M^2) (the native twin does the same,
    odesat_native.cc subsume_clauses_indexed).

    An empty clause (possible from resolving complementary units) appears
    in no occurrence list but subsumes everything under the reference's
    all-pairs semantics (src/cnf.rs:521-539: the strict subset of every
    clause) — special-cased so the indexed scan keeps the same final set."""
    if frozenset() in clauses:
        clauses.intersection_update({frozenset()})
        return
    occ = {}
    for clause in clauses:
        for lit in clause:
            occ.setdefault(lit, []).append(clause)
    to_remove = [
        clause
        for clause in clauses
        if any(
            other is not clause and len(other) < len(clause) and clause >= other
            for lit in clause
            for other in occ[lit]
        )
    ]
    for clause in to_remove:
        clauses.discard(clause)
