"""Simplification trace and witness reconstruction.

Parity with the reference (reference: src/cnf.rs:501-519, 558-585): the
preprocessor records each rewriting step; after the reduced formula is
solved, the steps are replayed **in reverse** to extend the assignment to
the eliminated variables:

* VariableElimination(var, modified_pos_clauses): the eliminated variable
  is set to the negation of whether the positive-occurrence clauses
  (minus the eliminated literal) are already satisfied
  (src/cnf.rs:504-507);
* BlockedClauseElimination(var, clause): flip ``var`` if the eliminated
  clause is unsatisfied (src/cnf.rs:508-513).

Evaluation inserts missing variables as False, matching
``evaluate_cnf_set``'s ``or_insert(false)`` (src/cnf.rs:276).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

from odesat_tpu_torch.cnf.evaluate import evaluate_clauses


@dataclass(frozen=True)
class VariableElimination:
    variable: int
    modified_pos_clauses: frozenset  # frozenset[frozenset[Literal]]


@dataclass(frozen=True)
class BlockedClauseElimination:
    variable: int
    clause: frozenset  # frozenset[Literal]


SimplificationStep = Union[VariableElimination, BlockedClauseElimination]


@dataclass
class SimplificationTrace:
    steps: list = field(default_factory=list)

    def add(self, step: SimplificationStep) -> None:
        self.steps.append(step)

    def extend(self, other: "SimplificationTrace") -> None:
        self.steps.extend(other.steps)

    def __len__(self) -> int:
        return len(self.steps)


def reconstruct_witness(assignment: dict, trace: SimplificationTrace) -> dict:
    """Replay the trace in reverse over ``assignment`` (in place; also
    returned). Reference: src/cnf.rs:501-519."""
    for step in reversed(trace.steps):
        if isinstance(step, VariableElimination):
            value = not evaluate_clauses(assignment, step.modified_pos_clauses)
            assignment[step.variable] = value
        else:  # BlockedClauseElimination
            if not evaluate_clauses(assignment, [step.clause]):
                assignment[step.variable] = not assignment[step.variable]
    return assignment
