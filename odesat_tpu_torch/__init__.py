"""odesat_tpu_torch — the PyTorch / CUDA port of odesat_tpu for one NVIDIA H100.

The same digital-memcomputing ODE SAT solver as ``odesat_tpu`` (Bearden,
Pei & Di Ventra, arXiv:2011.06551), written in PyTorch with hand-written
CUDA kernels for Hopper (``sm_90a``). The module paths mirror the JAX
package, so each counterpart sits at the same place:

* ``cnf``            — DIMACS IO, normalization, oracle, array compiler;
* ``ops.rhs``        — the torch twin of the ODE right-hand side;
* ``ops.fused_chunk``— the resident multi-step chunk kernel (CUDA) and its
  plain torch version;
* ``models.ode``     — state, integrators, chunk runners, ``simulate_batch``;
* ``models.stoch``   — the stochastic engine, ``search``;
* ``models.hybrid``  — both engines racing, ``hybrid_search``;
* ``models.loop``    — the chunked host loop (snapshots, profiler traces);
* ``utils.checkpoint``, ``utils.tts`` — snapshots and exact time to solution;
* ``tools.uf250_tts`` — the uf250 time-to-solution protocol on the card;
* ``cli``            — ``python -m odesat_tpu_torch {solve,batch,inter,stoch,hybrid,gen}``.

The package never imports jax; ``interop`` carries formulas and states to
and from numpy so tests can hold it against the JAX package. Importing
the package imports no torch either: the submodules that need it import
it themselves, and the names below (the ``__all__`` of the JAX package's
facade, as in each subpackage) resolve on first use.
"""

import importlib
import sys

__version__ = "0.1.0"

# The only names of the JAX package's exported API that the port does not
# offer, each with its reason.
NOT_OFFERED = {
    "enable_compilation_cache": "XLA's persistent compilation cache; the port builds each CUDA "
    "source once into csrc/_build and loads it once a process",
    "build_onehot": "the onehot dv strategy, a TPU layout (gathers beat scatters there), is "
    "not offered",
    "accumulate_dv_onehot": "the onehot dv strategy, a TPU layout (gathers beat scatters "
    "there), is not offered",
    "traj_sharding": "a jax NamedSharding; a rank of the port holds its own rows "
    "(parallel/dist.local_rows)",
    "replicated": "a jax NamedSharding; a rank of the port holds its own rows "
    "(parallel/dist.local_rows)",
}


def lazy_exports(package: str, exports: dict):
    """A module ``__getattr__`` for ``package`` that imports each name of
    ``exports`` on first use: ``"module:attribute"`` names an attribute of a
    module, ``"module"`` the module itself. A name of :data:`NOT_OFFERED`
    raises AttributeError with its reason."""

    def __getattr__(name):
        target = exports.get(name)
        if target is None:
            reason = NOT_OFFERED.get(name)
            raise AttributeError(f"module {package!r} has no attribute {name!r}"
                                 + (f": not offered by the port ({reason})" if reason else ""))
        module, _, attr = target.partition(":")
        value = importlib.import_module(module)
        if attr:
            value = getattr(value, attr)
        setattr(sys.modules[package], name, value)
        return value

    return __getattr__


_P = "odesat_tpu_torch"
_EXPORTS = {
    **{name: f"{_P}.cnf:{name}" for name in (
        "CNFFormula", "FormulaArrays", "Literal", "bandwidth_reorder", "cnf_to_dimacs",
        "compile_formula", "evaluate_cnf", "normalize_cnf_variables", "parse_dimacs",
        "render_variable_map")},
    "ODEConfig": f"{_P}.utils.config:ODEConfig",
    "SolverConfig": f"{_P}.utils.config:SolverConfig",
    "SolveResult": f"{_P}.models.ode:SolveResult",
    "simulate": f"{_P}.models.ode:simulate",
    "simulate_batch": f"{_P}.models.ode:simulate_batch",
    "search": f"{_P}.models.stoch:search",
    "hybrid_search": f"{_P}.models.hybrid:hybrid_search",
    "preprocess_formula": f"{_P}.preprocess:preprocess_formula",
    "reconstruct_witness": f"{_P}.preprocess:reconstruct_witness",
    **{name: f"{_P}.{name}" for name in ("cnf", "models", "ops", "parallel", "preprocess",
                                          "utils")},
    "ode": f"{_P}.models.ode",
    "stoch": f"{_P}.models.stoch",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
