"""Resolution machinery: occurrence index, resolvents, blocked clauses.

Parity with the reference (reference: src/cnf.rs:418-498, 587-631),
including its load-bearing quirks:

* a resolvent that is a tautology is skipped (the combine loop clears and
  breaks on a complementary pair — src/cnf.rs:466-470);
* an **empty** resolvent — which would be a proof of UNSAT — is silently
  dropped (src/cnf.rs:474-476); the preprocessor therefore never detects
  UNSAT, exactly like the reference;
* consequently ``is_blocked`` (src/cnf.rs:587-599) reduces to "some
  literal has no surviving resolvents", since survivors are never
  tautologies.
"""

from __future__ import annotations

from odesat_tpu_torch.cnf.formula import Literal
from odesat_tpu_torch.preprocess.sets import is_tautology


def build_occurrence_index(clauses: set) -> dict:
    """var -> (set of clauses with positive occurrence, set with negative)
    (reference: src/cnf.rs:418-438)."""
    index: dict = {}
    for clause in clauses:
        for lit in clause:
            pos, neg = index.setdefault(lit.variable, (set(), set()))
            (neg if lit.is_negated else pos).add(clause)
    return index


def calculate_resolvents(index: dict, clause: frozenset, variable: int) -> list:
    """All non-tautological, non-empty resolvents of ``clause`` on
    ``variable`` against the opposing occurrence list
    (reference: src/cnf.rs:440-479)."""
    pos_clauses, neg_clauses = index[variable]
    opposing = neg_clauses if Literal(variable, False) in clause else pos_clauses

    own = {lit for lit in clause if lit.variable != variable}
    own_pairs = {(lit.variable, lit.is_negated) for lit in own}

    resolvents = []
    for other in opposing:
        combined = set(own)
        tautological = False
        for lit in other:
            if lit.variable == variable:
                continue
            if (lit.variable, not lit.is_negated) in own_pairs:
                tautological = True
                break
            combined.add(lit)
        if not tautological and combined:
            resolvents.append(frozenset(combined))
    return resolvents


def calculate_var_resolvents(index: dict, variable: int) -> set:
    """Union of resolvents over every positive-occurrence clause
    (reference: src/cnf.rs:481-498)."""
    pos_clauses, _ = index[variable]
    out: set = set()
    for clause in pos_clauses:
        out.update(calculate_resolvents(index, clause, variable))
    return out


def is_blocked(clause: frozenset, index: dict):
    """Return the blocking variable if every resolvent of ``clause`` on
    some literal is a tautology (reference: src/cnf.rs:587-599). Literals
    are scanned in BTreeSet order for determinism."""
    for lit in sorted(clause):
        resolvents = calculate_resolvents(index, clause, lit.variable)
        if all(is_tautology(r) for r in resolvents):  # == empty, see module doc
            return lit.variable
    return None
