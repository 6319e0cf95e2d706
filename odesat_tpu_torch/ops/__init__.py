"""Device compute ops: the torch twin of the ODE right-hand side
(``rhs``), the resident chunk kernel with its plain torch version
(``fused_chunk``) and the nvcc build of the CUDA sources (``_cuda``)."""


from odesat_tpu_torch import lazy_exports

_O = "odesat_tpu_torch.ops"
_EXPORTS = {
    **{name: f"{_O}.rhs:{name}" for name in (
        "accumulate_dv_gather", "accumulate_dv_segment", "clause_values",
        "compute_derivatives", "top2_min")},
    "fused_supported": f"{_O}.fused_chunk:fused_supported",
    "make_fused_chunk": f"{_O}.fused_chunk:make_fused_chunk",
    "make_fused_stoch_chunk": f"{_O}.stoch_chunk:make_fused_stoch_chunk",
    "stoch_fused_supported": f"{_O}.stoch_chunk:stoch_fused_supported",
    # B10's builder; JAX's name for it
    "make_pallas_rhs": f"{_O}.rhs_kernel:make_rhs_kernel",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
