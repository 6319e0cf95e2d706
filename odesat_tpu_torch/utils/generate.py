"""Random CNF instance generation for benchmarks and property tests.

The reference ships only three fixture files (tests/{easy,small,hard}.cnf);
BASELINE.md's measurement configs additionally call for random 3-SAT at
n=1k, m/n=4.3 and uf250-class instances, so the rebuild generates them.
"""

from __future__ import annotations

import numpy as np

from odesat_tpu_torch.cnf.formula import CNFFormula, Literal


def random_ksat(
    n_vars: int,
    n_clauses: int,
    k: int = 3,
    seed: int = 0,
    planted: bool = False,
) -> CNFFormula:
    """Uniform random k-SAT: each clause draws k distinct variables and
    independent polarities. With ``planted=True`` a hidden assignment is
    drawn first and every clause is forced to satisfy it (guaranteed SAT;
    useful for time-to-solution benchmarks).
    """
    rng = np.random.default_rng(seed)
    hidden = rng.integers(0, 2, size=n_vars + 1).astype(bool) if planted else None

    clauses = []
    for _ in range(n_clauses):
        variables = rng.choice(np.arange(1, n_vars + 1), size=k, replace=False)
        while True:
            negs = rng.integers(0, 2, size=k).astype(bool)
            if hidden is None:
                break
            # clause satisfied by hidden iff some literal agrees with it
            if any(hidden[v] != n for v, n in zip(variables, negs)):
                break
        clauses.append(tuple(Literal(int(v), bool(n)) for v, n in zip(variables, negs)))

    return CNFFormula(clauses, n_vars)


def uf_instance(n_vars: int = 250, ratio: float = 4.26, seed: int = 0) -> CNFFormula:
    """SATLIB uf-class stand-in: random 3-SAT at the phase-transition
    ratio (uf250: n=250, m=1065)."""
    return random_ksat(n_vars, int(round(n_vars * ratio)), k=3, seed=seed, planted=True)


def random_local_ksat(
    n_vars: int,
    n_clauses: int,
    k: int = 3,
    locality: int = 128,
    seed: int = 0,
    planted: bool = True,
) -> CNFFormula:
    """Locally-structured random k-SAT: each clause draws its variables
    from a window of ``locality`` consecutive variable names around a
    random center. Models the variable locality of encoder-generated
    instances (circuit/BMC/planning CNFs number variables in generation
    order, so clauses touch nearby indices) — the regime where the
    streaming kernel's per-span variable windows pay off."""
    if locality < k:
        raise ValueError(
            f"locality={locality} is narrower than the clause width k={k}: "
            "a clause cannot draw k distinct variables from the window"
        )
    rng = np.random.default_rng(seed)
    hidden = rng.integers(0, 2, size=n_vars + 1).astype(bool) if planted else None
    clauses = []
    for _ in range(n_clauses):
        lo = int(rng.integers(1, max(n_vars - locality + 1, 2)))
        hi = min(lo + locality, n_vars + 1)
        variables = rng.choice(np.arange(lo, hi), size=k, replace=False)
        while True:
            negs = rng.integers(0, 2, size=k).astype(bool)
            if hidden is None or any(hidden[v] != n for v, n in zip(variables, negs)):
                break
        clauses.append(tuple(Literal(int(v), bool(n)) for v, n in zip(variables, negs)))
    return CNFFormula(clauses, n_vars)
