"""Device compute ops: the torch twin of the ODE right-hand side
(``rhs``), the resident chunk kernel with its plain torch version
(``fused_chunk``) and the nvcc build of the CUDA sources (``_cuda``)."""
