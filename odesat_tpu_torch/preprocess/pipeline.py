"""Preprocessing driver: BCE sweep + greedy bounded variable elimination.

Parity with the reference driver (reference: src/cnf.rs:633-840): raise
the clause-to-variable ratio toward a target (default 7.0,
src/main.rs:150-154) because the ODE engine struggles at low density
(reference README.md:34). Differences, all deliberate:

* candidate scans run in **sorted variable order** with strict-less
  tie-breaking, so preprocessing is deterministic (the reference iterates
  HashSets — its output clause set is run-to-run nondeterministic);
* ``min_ratio_resolvant``'s per-candidate resolvents are computed once
  and the winner's reused (the reference recomputes the winner's
  resolvents implicitly by storing them — same result).

Semantics preserved: blocked-clause elimination does not decrement
``varnum``; variable elimination does (src/cnf.rs:685); an elimination is
only taken while the resulting ratio stays <= target (src/cnf.rs:749-753);
the final sweep subsumes clauses (src/cnf.rs:808).
"""

from __future__ import annotations

from odesat_tpu_torch.cnf.formula import CNFFormula, Literal
from odesat_tpu_torch.preprocess.resolution import (
    build_occurrence_index,
    calculate_var_resolvents,
    is_blocked,
)
from odesat_tpu_torch.preprocess.sets import (
    CNFFormulaSet,
    from_formula_set,
    is_tautology,
    subsume_clauses,
    to_formula_set,
)
from odesat_tpu_torch.preprocess.trace import (
    BlockedClauseElimination,
    SimplificationTrace,
    VariableElimination,
)


def eliminate_if_blocked(clause: frozenset, clauses: set, index: dict):
    """If ``clause`` is blocked, remove it from the formula and the index;
    return (changed_vars, trace_step) (reference: src/cnf.rs:601-631)."""
    var = is_blocked(clause, index)
    if var is None:
        return None
    changed = set()
    for lit in clause:
        changed.add(lit.variable)
        pos, neg = index.setdefault(lit.variable, (set(), set()))
        (neg if lit.is_negated else pos).discard(clause)
    clauses.discard(clause)
    return changed, BlockedClauseElimination(var, clause)


def eliminate_variable(
    formula: CNFFormulaSet, index: dict, variable: int, resolvents: set
):
    """Eliminate ``variable`` by clause distribution; return
    (changed_vars, modified_pos_clauses) where the latter feeds witness
    reconstruction (reference: src/cnf.rs:633-715)."""
    changed: set = set()
    if variable not in index:
        return changed, frozenset()
    pos_clauses, neg_clauses = index.pop(variable)
    originals = pos_clauses | neg_clauses

    vars_to_update = {lit.variable for clause in originals for lit in clause}
    for var in vars_to_update:
        changed.add(var)
        if var in index:
            pos, neg = index[var]
            pos.difference_update(originals)
            neg.difference_update(originals)

    formula.clauses.difference_update(originals)
    formula.clauses.update(resolvents)
    formula.varnum -= 1

    for resolvent in resolvents:
        for lit in resolvent:
            pos, neg = index.setdefault(lit.variable, (set(), set()))
            (neg if lit.is_negated else pos).add(resolvent)

    modified_pos = frozenset(
        clause - {Literal(variable, False)} for clause in pos_clauses
    )
    return changed, modified_pos


def min_ratio_resolvant(
    variables: set, index: dict, formula: CNFFormulaSet, target_ratio: float
):
    """Greedy pick: the variable whose elimination minimizes the resulting
    clause-to-variable ratio, accepted only if that ratio <= target
    (reference: src/cnf.rs:717-754)."""
    best = None
    smallest = float("inf")
    for variable in sorted(variables):
        if variable not in index:
            continue
        pos_clauses, neg_clauses = index[variable]
        resolvents = calculate_var_resolvents(index, variable)
        resolvents = {r for r in resolvents if not is_tautology(r)}
        subsume_clauses(resolvents)

        clause_count = (
            len(formula.clauses) - len(pos_clauses) - len(neg_clauses) + len(resolvents)
        )
        var_count = formula.varnum - 1
        new_ratio = clause_count / var_count if var_count > 0 else float("inf")
        if new_ratio < smallest:
            smallest = new_ratio
            best = (variable, resolvents)

    if smallest > target_ratio:
        return None
    return best


def preprocessing_loop(
    formula: CNFFormulaSet, index: dict, target_ratio: float
) -> SimplificationTrace:
    """Reference: src/cnf.rs:756-829. Initial BCE sweep, then greedy VE
    (with BCE retries on fresh resolvents) until no elimination keeps the
    ratio under target, then a final subsumption pass."""
    trace = SimplificationTrace()

    # Initial blocked-clause sweep (clauses snapshotted first, then each
    # re-checked at elimination time, like the reference's two-phase scan).
    blocked = [c for c in sorted(formula.clauses, key=sorted) if is_blocked(c, index)]
    for clause in blocked:
        result = eliminate_if_blocked(clause, formula.clauses, index)
        if result is not None:
            trace.add(result[1])

    elim_vars = set(index.keys())
    while True:
        pick = min_ratio_resolvant(elim_vars, index, formula, target_ratio)
        if pick is None:
            break
        variable, resolvents = pick
        elim_vars = set()

        changed, modified_pos = eliminate_variable(formula, index, variable, resolvents)
        trace.add(VariableElimination(variable, modified_pos))
        elim_vars.update(changed)

        for resolvent in sorted(resolvents, key=sorted):
            if resolvent not in formula.clauses:
                continue
            result = eliminate_if_blocked(resolvent, formula.clauses, index)
            if result is not None:
                changed2, step = result
                trace.add(step)
                elim_vars.update(changed2)

    subsume_clauses(formula.clauses)
    return trace


def preprocess_formula(formula: CNFFormula, target_ratio: float = 7.0, native=None):
    """End-to-end preprocessing: CNFFormula -> (reduced CNFFormula, trace)
    (reference: src/cnf.rs:833-840 + conversions in src/main.rs:163-165).

    ``native``: True forces the C++ implementation, False the Python one,
    None (default) picks native when the library builds and loads
    (odesat_tpu_torch/native; parity-tested in
    tests/test_torch_preprocess.py). The native library is host code, not
    a kernel, so falling back to Python is allowed here."""
    if native is not False:
        from odesat_tpu_torch import native as native_mod

        if native_mod.is_available():
            return native_mod.preprocess_native(formula, target_ratio)
        if native:
            raise RuntimeError("native preprocessing requested but library unavailable")
    formula_set = to_formula_set(formula)
    index = build_occurrence_index(formula_set.clauses)
    trace = preprocessing_loop(formula_set, index, target_ratio)
    return from_formula_set(formula_set), trace
