"""Shared utilities: configuration, instance generation, logging, timing."""


from odesat_tpu_torch import lazy_exports

_U = "odesat_tpu_torch.utils"
_EXPORTS = {
    **{name: f"{_U}.config:{name}" for name in ("ODEConfig", "SolverConfig",
                                                  "zeta_for_density")},
    **{name: f"{_U}.logging:{name}" for name in ("Throughput", "chunk_metrics", "log_chunk",
                                                   "logger")},
    "load_state": f"{_U}.checkpoint:load_state",
    "save_state": f"{_U}.checkpoint:save_state",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
