"""Host-side CNF preprocessor (reference layer L1: src/cnf.rs:317-840):
blocked-clause elimination, greedy bounded variable elimination toward a
target clause-to-variable ratio, subsumption, and the simplification
trace used to reconstruct witnesses for eliminated variables.

The port's copy of ``odesat_tpu.preprocess``, pure Python on the port's
own ``cnf.formula`` so that it never imports jax; its Python path gives
the same reduced formula and trace as the JAX package's
(tests/test_torch_preprocess.py)."""

from odesat_tpu_torch.preprocess.pipeline import (
    eliminate_if_blocked,
    eliminate_variable,
    min_ratio_resolvant,
    preprocess_formula,
    preprocessing_loop,
)
from odesat_tpu_torch.preprocess.resolution import (
    build_occurrence_index,
    calculate_resolvents,
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
    reconstruct_witness,
)

__all__ = [
    "BlockedClauseElimination",
    "CNFFormulaSet",
    "SimplificationTrace",
    "VariableElimination",
    "build_occurrence_index",
    "calculate_resolvents",
    "calculate_var_resolvents",
    "eliminate_if_blocked",
    "eliminate_variable",
    "from_formula_set",
    "is_blocked",
    "is_tautology",
    "min_ratio_resolvant",
    "preprocess_formula",
    "preprocessing_loop",
    "reconstruct_witness",
    "subsume_clauses",
    "to_formula_set",
]
