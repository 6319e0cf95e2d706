"""Host-side CNF layer: data model, DIMACS IO, normalization, evaluation,
and the formula->device-array compiler. Pure Python and NumPy; the port's
copy of ``odesat_tpu.cnf`` (reference layer L0: src/cnf.rs:1-315)."""

from odesat_tpu_torch.cnf.arrays import FormulaArrays, compile_formula, slot_clause_map
from odesat_tpu_torch.cnf.dimacs import cnf_to_dimacs, parse_dimacs, parse_dimacs_file
from odesat_tpu_torch.cnf.evaluate import evaluate_clauses, evaluate_cnf, render_variable_map
from odesat_tpu_torch.cnf.formula import CNFFormula, Literal
from odesat_tpu_torch.cnf.normalize import (
    apply_variable_mapping,
    bandwidth_reorder,
    map_values_by_indices,
    normalize_cnf_variables,
)

__all__ = [
    "CNFFormula",
    "FormulaArrays",
    "Literal",
    "apply_variable_mapping",
    "bandwidth_reorder",
    "cnf_to_dimacs",
    "compile_formula",
    "evaluate_clauses",
    "evaluate_cnf",
    "map_values_by_indices",
    "normalize_cnf_variables",
    "parse_dimacs",
    "parse_dimacs_file",
    "render_variable_map",
    "slot_clause_map",
]
