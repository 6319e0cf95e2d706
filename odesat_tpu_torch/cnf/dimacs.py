"""DIMACS CNF reader/writer.

Behavioral parity with the reference parser (reference: src/cnf.rs:138-172,
221-244) with two deliberate, documented fixes:

* blank / content-free lines are **skipped** instead of becoming empty
  clauses (the reference's ``else`` branch at src/cnf.rs:154-168 turns any
  unrecognized line into an empty clause, making the formula trivially
  unsatisfiable; SURVEY.md C2 flags this as a quirk the rebuild must fix);
* a trailing ``%`` end-of-file marker (SATLIB convention) ends parsing.

Like the reference, each clause must be contained on a single line, the
header's ``nbclauses`` field is ignored, and literals after the ``0``
sentinel on a line are ignored.
"""

from __future__ import annotations

from odesat_tpu_torch.cnf.formula import CNFFormula, Literal


def parse_dimacs(text: str) -> CNFFormula:
    """Parse DIMACS CNF text into a :class:`CNFFormula`."""
    clauses = []
    varnum = None

    for line in text.splitlines():
        stripped = line.strip()
        if not stripped:
            continue  # divergence from reference: skip blank lines
        if stripped.startswith("c"):
            continue
        if stripped == "%":
            break  # SATLIB end marker
        if stripped.startswith("p"):
            parts = stripped.split()
            # "p cnf nbvar nbclauses" — nbclauses ignored (reference:
            # src/cnf.rs:152).
            if len(parts) < 3 or parts[1] != "cnf":
                raise ValueError(f"malformed problem line: {line!r}")
            varnum = int(parts[2])
            continue
        literals = []
        for tok in stripped.split():
            if tok == "0":
                break
            value = int(tok)
            literals.append(Literal(abs(value), value < 0))
        if literals:
            clauses.append(tuple(literals))
        # divergence from reference: a line with no literals (e.g. a lone
        # "0") is skipped rather than recorded as an empty clause.

    return CNFFormula.from_clauses(clauses, varnum)


def parse_dimacs_file(path) -> CNFFormula:
    with open(path, "r", encoding="utf-8") as fh:
        return parse_dimacs(fh.read())


def cnf_to_dimacs(formula: CNFFormula) -> str:
    """Serialize a formula back to DIMACS (reference: src/cnf.rs:221-244)."""
    lines = [f"p cnf {formula.varnum} {formula.num_clauses}"]
    for clause in formula.clauses:
        toks = [str(-lit.variable if lit.is_negated else lit.variable) for lit in clause]
        lines.append(" ".join(toks) + " 0")
    return "\n".join(lines) + "\n"
