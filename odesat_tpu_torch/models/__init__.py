"""Solver engines: the continuous-time ODE engine (``ode``), the
stochastic engine (``stoch``), the hybrid portfolio racing both
(``hybrid``) and their chunked host loop (``loop``)."""


from odesat_tpu_torch import lazy_exports

_M = "odesat_tpu_torch.models"
_EXPORTS = {
    **{name: f"{_M}.ode:{name}" for name in (
        "ODEState", "SolveResult", "init_state", "make_chunk_runner", "make_step_fn",
        "simulate", "simulate_batch")},
    **{name: f"{_M}.stoch:{name}" for name in ("StochResult", "StochState", "search")},
    "ode": f"{_M}.ode",
    "stoch": f"{_M}.stoch",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
