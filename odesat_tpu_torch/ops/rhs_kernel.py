"""The single-step ODE right-hand side (kernel B10): a hand-written CUDA
kernel for Hopper and its plain torch version, the twin's ``gather`` RHS.

Replaces the TPU kernel ``odesat_tpu/ops/rhs_pallas.py::make_pallas_rhs``
(Pallas; call :172), reached by ``dv_strategy="pallas"``: one RHS pass
``(v, xs, xl) -> (dv, dxs, dxl, allsat)`` for a batch, in float32 or
float64, which the step function of ``models/ode.py`` integrates.

Design for the card (``rhs_launch`` in ``csrc/stream_chunk.cu``, beside B2,
sharing its clause- and variable-phase device code): one CTA per
trajectory. The TPU kernel gathers ``v`` and scatters dv with matmuls
against a stacked one-hot ``(K*Np, Mp)``, because the TPU gathers poorly;
here the clause phase gathers ``v`` by literal code into the clause's
running min and second min, and the variable phase sums each variable's
CSR occurrence list in a fixed order, recomputing each contribution from
those two words and the clause's xs and xl. ``v`` lives in shared memory;
the two clause words too while they fit (:func:`rhs_layout`), else in a
scratch row per trajectory. No float atomics.

What bounds it: the state crosses device memory every step (a single step
holds nothing on chip between steps), plus the gathers; the chunk kernels
B1 and B2 are the main path, this one serves ``--dv-strategy pallas``.

The plain version (:func:`rhs_plain`) is the twin's
``compute_derivatives`` with ``gather``. Its sum runs over the ``(Np, D)``
occurrence table with ``torch.sum``, in another order than the kernel's,
and the kernel factors each contribution as B1 does where the twin writes
the reference's two terms, so the two agree to a tolerance, not bit for
bit. Unit clauses are rejected, as ``rhs_pallas.py:74-78`` rejects them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays
from odesat_tpu_torch.ops import rhs as rhs_ops
from odesat_tpu_torch.ops.fused_chunk import chunk_tables, cuda_device
from odesat_tpu_torch.ops.stream_chunk import (
    Layout,
    kernel_threads,
    load_library,
    occurrence_codes,
    place_arg,
    place_items,
    raise_for,
)

# Kernel launches made through rhs_cuda in this process (see
# ops/fused_chunk.py's counter).
launches = 0

_ITEMSIZE = {torch.float32: 4, torch.float64: 8}


def rhs_layout(Np: int, Mp: int, itemsize: int) -> Optional[Layout]:
    """B10's placement: v resident, the clause words m1 and m2 in shared
    memory while they fit."""
    return place_items(dict(v=Np, m1=Mp, m2=Mp), itemsize)


def rhs_supported(fa: FormulaArrays, dtype: str = "float32") -> bool:
    """B10's gate: no unit clauses, and v (plus reduction scratch) in one
    CTA's shared memory."""
    itemsize = 8 if dtype == "float64" else 4
    return fa.min_width >= 2 and rhs_layout(fa.n_vars_padded, fa.n_clauses_padded,
                                            itemsize) is not None


@dataclass(frozen=True)
class RhsSpec:
    """One formula's B10 tables on one device."""

    device: torch.device
    lit_code: torch.Tensor  # (K*Mp,) int32
    occ_ptr: torch.Tensor  # (Np+1,) int32
    occ_code: torch.Tensor  # (nnz,) int32, 2*m + negated
    K: int
    Mp: int
    Np: int
    zeta: float
    paper: bool


def rhs_spec(fa: FormulaArrays, zeta: float, rigidity: str, device) -> RhsSpec:
    device = cuda_device(device)
    t = chunk_tables(fa)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=torch.int32)

    return RhsSpec(device, put(t.lit_code), put(t.occ_ptr), put(occurrence_codes(t)),
                   t.K, t.Mp, t.Np, float(zeta), rigidity == "paper")


def rhs_plain(v, xs, xl, dev, zeta: float, rigidity: str, bucket_slices):
    """The twin's ``gather`` RHS over the formula tensors ``dev`` (a
    ``models.ode.FormulaDevice`` on the state's device)."""
    return rhs_ops.compute_derivatives(
        v, xs, xl,
        lit_var=dev.lit_var, sign=dev.sign, lit_mask=dev.lit_mask,
        clause_mask=dev.clause_mask, var_occ=dev.var_occ, occ_mask=dev.occ_mask,
        zeta=zeta, rigidity=rigidity, dv_strategy="gather", bucket_slices=bucket_slices,
    )


def rhs_cuda(v, xs, xl, spec: RhsSpec):
    """Launch B10 once on the current stream of the state's device; returns
    (dv, dxs, dxl, allsat). Raises if the inputs are not what the kernel
    takes or if the launch is refused; never falls back."""
    global launches
    B = v.shape[0]
    dtype = v.dtype
    if dtype not in _ITEMSIZE:
        raise ValueError(f"the RHS kernel takes float32 or float64, not {dtype}")
    for name, t, n in (("v", v, spec.Np), ("xs", xs, spec.Mp), ("xl", xl, spec.Mp)):
        if t.device != spec.device:
            raise ValueError(f"{name} is on {t.device}, the formula on {spec.device}")
        if tuple(t.shape) != (B, n) or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype}; the kernel takes a "
                             f"contiguous ({B}, {n}) {dtype}")
    dv, dxs, dxl = torch.empty_like(v), torch.empty_like(xs), torch.empty_like(xl)
    allsat = torch.empty(B, dtype=torch.bool, device=spec.device)
    if B == 0:
        return dv, dxs, dxl, allsat
    layout = rhs_layout(spec.Np, spec.Mp, _ITEMSIZE[dtype])
    scratch = torch.empty((B * layout.row_words) or 1, dtype=dtype, device=spec.device)
    lib, _ = load_library()
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.rhs_launch(
            int(dtype == torch.float64), v.data_ptr(), xs.data_ptr(), xl.data_ptr(),
            dv.data_ptr(), dxs.data_ptr(), dxl.data_ptr(), allsat.data_ptr(),
            spec.lit_code.data_ptr(), spec.occ_ptr.data_ptr(), spec.occ_code.data_ptr(),
            scratch.data_ptr(), place_arg(layout), layout.row_words, layout.smem_bytes,
            B, spec.Np, spec.Mp, spec.K, int(spec.paper), kernel_threads(spec.Mp),
            spec.zeta, stream,
        )
    raise_for(lib, rc, "RHS kernel")
    launches += 1
    return dv, dxs, dxl, allsat


def make_rhs_kernel(fa: FormulaArrays, zeta: float, rigidity: str = "paper",
                    dtype: str = "float32"):
    """Build ``fn(v, xs, xl, dev) -> (dv, dxs, dxl, allsat)``. CUDA inputs
    go through B10 (its tables are moved to a device at first use there);
    CPU inputs through :func:`rhs_plain` over ``dev``; anything else
    raises. Raises ValueError for unit clauses and past the gate."""
    if fa.min_width < 2:
        raise ValueError(
            "the RHS kernel cannot represent unit-clause infinite gradients; "
            "use dv_strategy='gather'"
        )
    if rigidity not in ("paper", "reference"):
        raise ValueError(f"unknown rigidity mode: {rigidity!r}")
    if not rhs_supported(fa, dtype):
        raise ValueError(
            f"the RHS kernel cannot hold {fa.n_vars_padded} padded variables of {dtype} "
            "in one CTA's shared memory; use dv_strategy='gather'"
        )
    buckets = fa.bucket_slices if len(fa.bucket_slices) > 1 else None
    specs = {}

    def fn(v, xs, xl, dev=None):
        kind = v.device.type
        if kind == "cuda":
            spec = specs.get(v.device)
            if spec is None:
                spec = specs[v.device] = rhs_spec(fa, zeta, rigidity, v.device)
            return rhs_cuda(v, xs, xl, spec)
        if kind == "cpu":
            return rhs_plain(v, xs, xl, dev, zeta, rigidity, buckets)
        raise ValueError(f"no RHS kernel path for tensors on {v.device}")

    return fn
