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
* ``models.loop``    — the chunked host loop;
* ``cli``            — ``python -m odesat_tpu_torch inter``.

The package never imports jax; ``interop`` carries formulas and states to
and from numpy so tests can hold it against the JAX package. Importing
the package imports no torch either: the submodules that need it import
it themselves.
"""

__version__ = "0.1.0"
