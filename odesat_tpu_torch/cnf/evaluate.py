"""Ground-truth CNF evaluation — the oracle every solve is verified against.

Parity with the reference (reference: src/cnf.rs:246-287): variables
missing from the assignment are **defaulted to False and inserted into the
map** (the reference's ``entry(..).or_insert(false)`` at src/cnf.rs:253,
276 mutates the assignment; witness reconstruction depends on this).
"""

from __future__ import annotations

from odesat_tpu_torch.cnf.formula import CNFFormula


def evaluate_cnf(assignment: dict, formula: CNFFormula) -> bool:
    """True iff ``assignment`` satisfies every clause. Missing variables
    are set to False in-place (reference: src/cnf.rs:246-264)."""
    return evaluate_clauses(assignment, formula.clauses)


def evaluate_clauses(assignment: dict, clauses) -> bool:
    """Evaluate an iterable of clauses (each an iterable of Literals);
    used both on formulas and on preprocessor clause-sets (reference:
    src/cnf.rs:266-287)."""
    for clause in clauses:
        clause_result = False
        for lit in clause:
            value = assignment.setdefault(lit.variable, False)
            clause_result = clause_result or (not value if lit.is_negated else value)
        if not clause_result:
            return False
    return True


def render_variable_map(assignment: dict) -> str:
    """Render ``var 0/1`` lines. The reference iterates a HashMap (unordered
    output, src/cnf.rs:289-298); we sort by variable for determinism."""
    return "".join(f"{var} {1 if value else 0}\n" for var, value in sorted(assignment.items()))
