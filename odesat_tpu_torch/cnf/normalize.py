"""Variable normalization: dense renaming so variables index state vectors.

Parity with the reference (reference: src/cnf.rs:174-219, 301-315) with one
deliberate fix: the reference enumerates a ``HashSet`` to build the name
map (src/cnf.rs:211), making the mapping nondeterministic run-to-run;
here variables are **sorted** first (SURVEY.md C3 calls for this), so
normalization is deterministic and runs are replayable.

Semantics kept faithfully:

* literals whose variable is absent from the mapping are dropped
  (src/cnf.rs:189-191);
* the normalized formula keeps the **original** ``varnum``
  (src/cnf.rs:198), so the state vector may be longer than the number of
  used variables — the unused slots are inert.
"""

from __future__ import annotations

from odesat_tpu_torch.cnf.formula import CNFFormula, Literal


def apply_variable_mapping(var_mapping: dict, formula: CNFFormula) -> CNFFormula:
    """Rename variables per ``var_mapping``; unmapped literals are dropped
    (reference: src/cnf.rs:174-199)."""
    mapped_clauses = []
    for clause in formula.clauses:
        mapped = tuple(
            Literal(var_mapping[lit.variable], lit.is_negated)
            for lit in clause
            if lit.variable in var_mapping
        )
        mapped_clauses.append(mapped)
    return CNFFormula(mapped_clauses, formula.varnum)


def normalize_cnf_variables(formula: CNFFormula):
    """Return ``(name_map, normalized_formula)`` where ``name_map`` maps
    original variable names to dense indices ``0..k-1`` in sorted order
    (reference: src/cnf.rs:206-219, determinism fixed)."""
    variables = sorted(formula.variable_set())
    name_map = {old: new for new, old in enumerate(variables)}
    return name_map, apply_variable_mapping(name_map, formula)


def bandwidth_reorder(name_map: dict, formula: CNFFormula):
    """Relabel a *normalized* formula's variables with a reverse
    Cuthill-McKee order over the variable co-occurrence graph, composing
    the permutation into ``name_map`` so solution readout is unchanged.

    Purpose: the streaming kernels' per-span variable windows
    (ops/stream_pallas.py) only tighten when clauses touch nearby
    variable indices. Encoder-generated CNFs usually have that locality
    natively; RCM recovers it for instances whose numbering was
    scrambled. No reference counterpart (the reference has no layout
    notion); purely an internal relabeling — verified solutions map back
    through the composed ``name_map`` exactly as before."""
    used = sorted({lit.variable for clause in formula.clauses for lit in clause})
    adj = {v: set() for v in used}
    for clause in formula.clauses:
        vs = [lit.variable for lit in clause]
        for i, a in enumerate(vs):
            for b in vs[i + 1 :]:
                if a != b:
                    adj[a].add(b)
                    adj[b].add(a)
    degree = {v: len(adj[v]) for v in used}

    visited = set()
    order = []
    remaining = sorted(used, key=lambda v: (degree[v], v))
    for start in remaining:
        if start in visited:
            continue
        queue = [start]
        visited.add(start)
        while queue:
            v = queue.pop(0)
            order.append(v)
            for nb in sorted(adj[v], key=lambda u: (degree[u], u)):
                if nb not in visited:
                    visited.add(nb)
                    queue.append(nb)
    order.reverse()
    perm = {old: new for new, old in enumerate(order)}
    new_map = {name: perm[idx] for name, idx in name_map.items() if idx in perm}
    return new_map, apply_variable_mapping(perm, formula)


def map_values_by_indices(indices_map: dict, values) -> dict:
    """Compose a name map with an indexed solution vector back to original
    names (reference: src/cnf.rs:301-315). Indices out of range are
    skipped, matching the reference's ``values.get(index)``."""
    out = {}
    n = len(values)
    for key, index in indices_map.items():
        if 0 <= index < n:
            out[key] = bool(values[index])
    return out
