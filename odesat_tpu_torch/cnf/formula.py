"""Host-side CNF data model.

Port copy of ``odesat_tpu.cnf.formula``: the reference CNF AST (reference: src/cnf.rs:5-136).
The reference stores clauses as ndarray-of-struct; here the host model is
plain Python (it never touches the device) — the device representation is
the padded incidence arrays produced by :mod:`odesat_tpu_torch.cnf.arrays`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, NamedTuple


class Literal(NamedTuple):
    """A possibly-negated variable (reference: src/cnf.rs:5-18)."""

    variable: int
    is_negated: bool = False

    def negated(self) -> "Literal":
        return Literal(self.variable, not self.is_negated)

    def __str__(self) -> str:
        return f"¬{self.variable}" if self.is_negated else f"{self.variable}"


Clause = tuple  # tuple[Literal, ...]


@dataclass
class CNFFormula:
    """A CNF formula: ordered clauses + declared variable count.

    ``varnum`` is the declared number of variables (DIMACS header); the
    set of variables actually used may be smaller, and — matching the
    reference (src/cnf.rs:198) — state vectors are sized by ``varnum``,
    not by the used-variable count.
    """

    clauses: list = field(default_factory=list)  # list[tuple[Literal, ...]]
    varnum: int = 0

    @classmethod
    def from_clauses(cls, clauses: Iterable, varnum: int | None = None) -> "CNFFormula":
        clause_list = [tuple(c) for c in clauses]
        if varnum is None:
            # Match reference fallback: varnum = number of distinct used
            # variables (reference: src/cnf.rs:60-77).
            varnum = len({lit.variable for c in clause_list for lit in c})
        return cls(clause_list, varnum)

    @property
    def num_clauses(self) -> int:
        return len(self.clauses)

    @property
    def max_clause_width(self) -> int:
        return max((len(c) for c in self.clauses), default=0)

    def variable_set(self) -> set:
        """All variables used in any clause (reference: src/cnf.rs:116-124)."""
        return {lit.variable for clause in self.clauses for lit in clause}

    def clause_density(self) -> float:
        """Clause-to-variable ratio, computed against declared ``varnum``
        (reference: src/system.rs:165)."""
        return self.num_clauses / self.varnum if self.varnum else float("inf")

    def variable_clause_index_map(self) -> dict:
        """variable -> list[(clause_index, polarity)] where polarity is
        True for a positive occurrence (reference: src/cnf.rs:80-92)."""
        index: dict = {}
        for m, clause in enumerate(self.clauses):
            for lit in clause:
                index.setdefault(lit.variable, []).append((m, not lit.is_negated))
        return index

    def __str__(self) -> str:
        return " ∧ ".join(
            "(" + " ∨ ".join(str(lit) for lit in clause) + ")" for clause in self.clauses
        )
