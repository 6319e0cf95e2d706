"""The large-formula ODE chunk (kernel B2): a hand-written CUDA kernel for
Hopper, whose plain torch version is B1's.

Replaces the TPU kernel ``odesat_tpu/ops/stream_pallas.py::make_stream_chunk``
(Pallas; kernel body :252). Like it, one launch advances every trajectory
``chunk_steps`` Euler steps of the formulas that the resident chunk kernel
(B1, ops/fused_chunk.py) cannot hold, and like it, it computes exactly what
B1 computes: :func:`stream_chunk_plain` *is* :func:`fused_chunk_plain`.

Design for the card (``csrc/stream_chunk.cu``): one CTA per trajectory, the
grid exactly B. The TPU kernel streams sign-baked one-hot planes per
128-clause span with double-buffered DMA and runs the gather and the
scatter as matmuls, for the TPU's VMEM and its poor gathers; none of that
carries over. Here the formula's tables (a literal code per ``(k, m)``
slot and, per variable, a CSR list of ``2*m + negated`` codes) are read
from global memory, where every CTA reads the same bytes and they stay in
the 50 MB L2. Two words per clause (the running min and second min) take
the place of B1's K words per clause of contributions: the variable phase
recomputes each occurrence's contribution from them, bit for bit as B1's
clause phase computes it. The trajectory's arrays are placed by
:func:`stream_layout`: in shared memory while they fit, the rest in a
per-trajectory scratch row in global memory that the wrapper allocates.

What bounds it on the card: gathers from shared memory, L1 and L2 (the
clause phase reads K literal codes and K values of ``v`` per clause, the
variable phase four clause words per occurrence), and the block barriers
(two a fixed step, five an adaptive one); not device memory for the
formulas whose state fits the CTA. What the design does about it: ``v``
and the adaptive half step are always resident, the clause words that the
variable phase gathers come next, and the trial states that are read once
per step last. No float atomics; dv sums in the plain version's CSR order.

The gate is the kernel's own (:func:`stream_supported`): no unit clauses,
and ``v`` (and in adaptive mode the half step) plus 32 words of reduction
scratch in at most 232,448 bytes of shared memory, about 58,000 padded
variables for the fixed integrator and 29,000 for the adaptive one. The
scratch rows are sized per launch (:attr:`Layout.row_words` floats per
trajectory). The TPU kernel's budgets (8 MiB of plane staging, 2 GiB of
planes, a 128-aligned clause axis) have no counterpart: nothing here is a
plane.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays
from odesat_tpu_torch.ops import _cuda
from odesat_tpu_torch.ops.fused_chunk import (
    SMEM_LIMIT_BYTES,
    ChunkSpec,
    ChunkTables,
    check_chunk_config,
    check_state,
    chunk_tables,
    cuda_device,
    fused_chunk_plain,
    spec_fields,
)

# Kernel launches made through stream_chunk_cuda in this process. A plain
# integer that callers may reset; chip_smoke.py reads it to show that the
# main path went through the kernel.
launches = 0

# B2 computes what B1 computes: its plain version is B1's, under its own name.
stream_chunk_plain = fused_chunk_plain

RED_WORDS = 32  # reduction scratch at the start of shared memory (csrc kRed)
# the kernel's `enum Item`, in order
ITEMS = ("v", "hv", "fv", "m1", "m2", "xs", "xl", "hxs", "hxl", "fxs", "fxl")
# placement order: gathered K times per clause, then per occurrence, then once a step
_PRIORITY = ("v", "hv", "m1", "m2", "xs", "xl", "hxs", "hxl", "fv", "fxs", "fxl")
_RESIDENT = ("v", "hv")  # must be in shared memory
MAX_THREADS = 512


@dataclass(frozen=True)
class Layout:
    """Where a trajectory's arrays live, as the kernel's ``Place`` reads
    it: ``place[i]`` for ``ITEMS[i]`` is an element offset into shared
    memory when >= 0, and ``-(offset + 1)`` into the trajectory's scratch
    row when < 0 (0 for an item the mode does not use)."""

    place: tuple
    smem_bytes: int
    row_words: int  # scratch elements per trajectory


def place_items(sizes: dict, itemsize: int, limit: int = SMEM_LIMIT_BYTES) -> Optional[Layout]:
    """Place the arrays ``sizes`` (name -> elements) greedily in
    ``_PRIORITY`` order: into shared memory while the next one fits under
    ``limit`` bytes, else into the scratch row. None when a resident array
    does not fit."""
    smem, row = RED_WORDS, 0
    place = [0] * len(ITEMS)
    for name in _PRIORITY:
        n = sizes.get(name)
        if n is None:
            continue
        i = ITEMS.index(name)
        if (smem + n) * itemsize <= limit:
            place[i] = smem
            smem += n
        elif name in _RESIDENT:
            return None
        else:
            place[i] = -(row + 1)
            row += n
    return Layout(tuple(place), smem * itemsize, row)


def stream_layout(Np: int, Mp: int, fixed: bool, limit: int = SMEM_LIMIT_BYTES) -> Optional[Layout]:
    """B2's placement for ``Np`` padded variables and ``Mp`` padded clauses:
    v, m1, m2, xs, xl, and in adaptive mode the half step (hv, hxs, hxl)
    and the full-step trial (fv, fxs, fxl)."""
    sizes = dict(v=Np, m1=Mp, m2=Mp, xs=Mp, xl=Mp)
    if not fixed:
        sizes.update(hv=Np, fv=Np, hxs=Mp, hxl=Mp, fxs=Mp, fxl=Mp)
    return place_items(sizes, 4, limit)


def stream_supported(fa: FormulaArrays, fixed: bool = False) -> bool:
    """B2's gate: no unit clauses (their infinite gradients are the scan
    path's business, ops/rhs.py) and a layout whose resident part fits one
    CTA. ``fixed=False`` checks the adaptive layout."""
    return fa.min_width >= 2 and stream_layout(fa.n_vars_padded, fa.n_clauses_padded,
                                               fixed) is not None


def occurrence_codes(t: ChunkTables) -> np.ndarray:
    """``2*m + negated`` for each occurrence of ``t``'s CSR lists, in their
    order: the clause column and sign the variable phase needs."""
    slots = t.occ_slot.astype(np.int64)
    return (2 * (slots % t.Mp) + (t.lit_code[slots] & 1)).astype(np.int32)


def kernel_threads(Mp: int) -> int:
    """Threads per CTA: about two clauses a thread, whole warps, 64 to
    ``MAX_THREADS``."""
    return min(MAX_THREADS, max(64, 32 * -(-Mp // 64)))


@dataclass(frozen=True)
class StreamSpec(ChunkSpec):
    """A :class:`ChunkSpec` (what the plain version reads) plus B2's
    occurrence codes and its layout."""

    occ_code: torch.Tensor  # (nnz,) int32, 2*m + negated
    layout: Layout


def stream_spec(fa: FormulaArrays, zeta: float, ode, device) -> StreamSpec:
    """Check ``ode`` and the formula against B2 and move the tables to
    ``device``. Raises ValueError for float64, a batch-shared adaptive dt,
    unit clauses and formulas past the gate."""
    check_chunk_config(ode, "stream chunk kernel")
    fixed = ode.step_size is not None
    if fa.min_width < 2:
        raise ValueError(
            "stream chunk kernel cannot represent unit-clause infinite gradients; "
            "use the scan path (dv_strategy='gather')"
        )
    layout = stream_layout(fa.n_vars_padded, fa.n_clauses_padded, fixed)
    if layout is None:
        raise ValueError(
            f"stream chunk kernel unsupported for this formula: {fa.n_vars_padded} padded "
            f"variables exceed the {SMEM_LIMIT_BYTES} bytes of shared memory a CTA may "
            "hold; use the scan path"
        )
    device = cuda_device(device)
    t = chunk_tables(fa)
    occ_code = torch.as_tensor(occurrence_codes(t)).to(device)
    return StreamSpec(**spec_fields(fa, zeta, ode, device, t), occ_code=occ_code,
                      layout=layout)


# ---------------------------------------------------------------- kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong


def _declare(lib) -> None:
    lib.stream_chunk_launch.argtypes = (
        [_P] * 14 + [ctypes.POINTER(_LL), _LL] + [_I] * 10 + [_F] * 4 + [_P]
    )
    lib.stream_chunk_launch.restype = _I
    lib.rhs_launch.argtypes = (
        [_I] + [_P] * 11 + [ctypes.POINTER(_LL), _LL] + [_I] * 7 + [ctypes.c_double, _P]
    )
    lib.rhs_launch.restype = _I
    lib.shard_stream_launch.argtypes = (  # B5 (ops/shard_stream.py)
        [_I] + [_P] * 15 + [ctypes.POINTER(_LL), _LL] + [_I] * 8 + [_F] * 2 + [_P]
    )
    lib.shard_stream_launch.restype = _I
    lib.shard_chunk_launch.argtypes = (  # B6 (ops/shard_chunk.py)
        [_I, _I] + [_P] * 15 + [_I] + [_P] * 3 + [_I] * 7 + [_F] * 4 + [_P]
    )
    lib.shard_chunk_launch.restype = _I
    lib.stream_chunk_smem_limit.argtypes = []
    lib.stream_chunk_smem_limit.restype = _I
    lib.stream_chunk_error_string.argtypes = [_I]
    lib.stream_chunk_error_string.restype = ctypes.c_char_p


def load_library():
    """Build (at first use) and load ``csrc/stream_chunk.cu`` (B2, B5, B6 and B10).
    Returns ``(lib, build)``."""
    return _cuda.load("stream_chunk", _declare)


def place_arg(layout: Layout):
    """The layout's placement as the ``const long long*`` the C entry
    points take."""
    return (_LL * len(ITEMS))(*layout.place)


def raise_for(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.stream_chunk_error_string(rc).decode())


def stream_chunk_cuda(state, spec: StreamSpec, chunk_steps: int):
    """Launch B2 once on the current stream of the state's device, with a
    fresh scratch row per trajectory. Raises if the state is not what the
    kernel takes or if the launch is refused; never falls back."""
    global launches
    if spec.device.type != "cuda":
        raise ValueError(f"the stream chunk kernel runs on CUDA tensors, not {spec.device}")
    check_state(state, spec)
    B = state.v.shape[0]
    if B == 0:
        return state
    lib, _ = load_library()
    out = [torch.empty_like(t) for t in state]
    lay = spec.layout
    scratch = torch.empty((B * lay.row_words) or 1, dtype=torch.float32, device=spec.device)
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.stream_chunk_launch(
            *(t.data_ptr() for t in state),
            *(t.data_ptr() for t in out),
            spec.lit_code.data_ptr(), spec.occ_ptr.data_ptr(), spec.occ_code.data_ptr(),
            scratch.data_ptr(), place_arg(lay), lay.row_words, lay.smem_bytes,
            B, spec.Np, spec.Mp, spec.K, int(chunk_steps),
            int(spec.fixed), int(spec.paper), int(spec.bf16), kernel_threads(spec.Mp),
            spec.zeta, spec.dt_fixed or 0.0, spec.tol, spec.xl_cap,
            stream,
        )
    raise_for(lib, rc, "stream chunk kernel")
    launches += 1
    return type(state)(*out)


def make_stream_chunk(fa: FormulaArrays, zeta: float, ode, chunk_steps: int, device):
    """Build ``fn(state, dev=None) -> state`` advancing every trajectory
    ``chunk_steps`` steps in one launch of B2. CUDA states go through the
    kernel; CPU states (the tests) through :func:`stream_chunk_plain`;
    anything else raises. ``dev`` is accepted for signature parity with the
    scan runner and ignored: the formula is in ``fn.spec``."""
    spec = stream_spec(fa, zeta, ode, device)

    def fn(state, dev=None):
        kind = state.v.device.type
        if kind == "cuda":
            return stream_chunk_cuda(state, spec, chunk_steps)
        if kind == "cpu":
            return stream_chunk_plain(state, spec, chunk_steps)
        raise ValueError(f"no stream chunk path for tensors on {state.v.device}")

    fn.spec = spec
    return fn
