"""The large-formula ODE chunk (kernel B2): a hand-written CUDA kernel for
Hopper, whose plain torch version is B1's.

Replaces the TPU kernel ``odesat_tpu/ops/stream_pallas.py::make_stream_chunk``
(Pallas; kernel body :252). Like it, one launch advances every trajectory
``chunk_steps`` Euler steps of the formulas that the resident chunk kernel
(B1, ops/fused_chunk.py) cannot hold, and like it, it computes exactly what
B1 computes: :func:`stream_chunk_plain` *is* :func:`fused_chunk_plain`.

Design for the card (``csrc/stream_chunk.cu`` over ``csrc/ode_lanes.cuh``,
B1's device code): one CTA per tile of R trajectories, a trajectory on one
lane of each thread group, for the whole chunk. The TPU kernel streams
sign-baked one-hot planes per 128-clause span with double-buffered DMA and
runs the gather and the scatter as matmuls, for the TPU's VMEM and its
poor gathers; none of that carries over. Here the tile's ``v`` window (and
the adaptive half step) sits in shared memory, interleaved ``[i][r]``, and
``xs``, ``xl``, the contributions and the adaptive scratch live in a device
scratch buffer tiled ``[x][r]`` (:func:`stream_scratch_floats` floats a
tile), so every access of a group is R neighbouring words, one 128-byte
line at R = 32. The clause phase computes each slot's contribution as B1
does and writes it at its occurrence's CSR position (:func:`slot_positions`),
so the variable phase reads each variable's list as a stream. The first
step reads ``xs``, ``xl`` from the row-major input and the last writes the
row-major output: no tiling pass. The tables are read from global memory,
where every CTA reads the same bytes and they stay in the 50 MB L2.

What bounds it on the card: device-memory bytes. A fixed step moves xs and
xl (read and written) and the contributions (written and read), ``4*Mp +
2*nnz`` words a trajectory. No float atomics; dv sums in the plain
version's CSR order, so B2 equals B1 and the plain version bit for bit.

The gate is the kernel's own (:func:`stream_supported`): no unit clauses,
and the ``v`` window (and in adaptive mode the half step) of one
trajectory plus the lane words in at most 232,448 bytes of shared memory,
about 58,000 padded variables for the fixed integrator and 29,000 for the
adaptive one. R (:func:`stream_lanes`) is the largest power of two up to
32 that fits, halved by a launch whose last wave of tiles would leave the
card idle (:func:`launch_lanes`). The TPU kernel's budgets (8 MiB of plane staging, 2 GiB of
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
    clause_segments,
    cuda_device,
    fused_chunk_plain,
    lane_threads,
    largest_lanes,
    launch_lanes,
    spec_fields,
)
from odesat_tpu_torch.ops.tiles import n_tiles

# Kernel launches made through stream_chunk_cuda in this process. A plain
# integer that callers may reset; chip_smoke.py reads it to show that the
# main path went through the kernel.
launches = 0

# B2 computes what B1 computes: its plain version is B1's, under its own name.
stream_chunk_plain = fused_chunk_plain

def stream_smem_bytes(Np: int, fixed: bool, lanes: int = 1) -> int:
    """B2's shared memory at ``lanes`` trajectories, as ``csrc/ode_lanes.cuh``
    carves it (``stream_chunk_smem_bytes``): the lane flags and errors (3 +
    3R words) and the v window, in adaptive mode also hv."""
    return 4 * (3 + 3 * lanes + lanes * Np * (1 if fixed else 2))


def stream_lanes(Np: int, fixed: bool, limit: int = SMEM_LIMIT_BYTES) -> Optional[int]:
    """The trajectories one CTA of B2 can take: the largest power of two up
    to :data:`MAX_LANES` whose windows fit, None when one trajectory's does
    not (a launch may take fewer, :func:`launch_lanes`)."""
    return largest_lanes(lambda lanes: stream_smem_bytes(Np, fixed, lanes), limit)


def stream_scratch_floats(Np: int, Mp: int, nnz: int, fixed: bool, lanes: int) -> int:
    """Device scratch a tile of B2 needs, in floats: xs, xl and the
    contributions, in adaptive mode also dxs1, dxl1 and fv
    (``stream_chunk_scratch_floats``)."""
    return lanes * (2 * Mp + nnz + (0 if fixed else 2 * Mp + Np))


def stream_supported(fa: FormulaArrays, fixed: bool = False) -> bool:
    """B2's gate: no unit clauses (their infinite gradients are the scan
    path's business, ops/rhs.py) and a v window of one trajectory that fits
    one CTA. ``fixed=False`` checks the adaptive one (v and hv)."""
    return fa.min_width >= 2 and stream_lanes(fa.n_vars_padded, fixed) is not None


def slot_positions(t: ChunkTables) -> np.ndarray:
    """The CSR position of each ``(k, m)`` slot (-1 at padding): where the
    clause phase writes the slot's contribution, so that each variable's
    contributions lie in a row."""
    pos = np.full(t.K * t.Mp, -1, dtype=np.int32)
    pos[t.occ_slot] = np.arange(t.occ_slot.size, dtype=np.int32)
    return pos


def occurrence_codes(t: ChunkTables) -> np.ndarray:
    """``2*m + negated`` for each occurrence of ``t``'s CSR lists, in their
    order: the clause column and sign that B5's and B6's pass read."""
    slots = t.occ_slot.astype(np.int64)
    return (2 * (slots % t.Mp) + (t.lit_code[slots] & 1)).astype(np.int32)


@dataclass(frozen=True)
class StreamSpec(ChunkSpec):
    """A :class:`ChunkSpec` (what the plain version reads) plus B2's slot
    positions and the trajectories a CTA takes."""

    slot_pos: torch.Tensor  # (K*Mp,) int32, the CSR position of each slot
    segments: torch.Tensor  # (nseg, 4) int32, clause_segments
    lanes: int


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
    lanes = stream_lanes(fa.n_vars_padded, fixed)
    if lanes is None:
        raise ValueError(
            f"stream chunk kernel unsupported for this formula: {fa.n_vars_padded} padded "
            f"variables exceed the {SMEM_LIMIT_BYTES} bytes of shared memory a CTA may "
            "hold; use the scan path"
        )
    device = cuda_device(device)
    t = chunk_tables(fa)
    slot_pos = torch.as_tensor(slot_positions(t)).to(device)
    segments = torch.as_tensor(clause_segments(fa)).to(device)
    return StreamSpec(**spec_fields(fa, zeta, ode, device, t), slot_pos=slot_pos,
                      segments=segments, lanes=lanes)


# ---------------------------------------------------------------- kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _declare(lib) -> None:
    lib.stream_chunk_launch.argtypes = [_P] * 14 + [_I] + [_P] + [_I] * 11 + [_F] * 4 + [_P]
    lib.stream_chunk_launch.restype = _I
    lib.stream_chunk_smem_bytes.argtypes = [_I] * 3
    lib.stream_chunk_smem_bytes.restype = ctypes.c_size_t
    lib.stream_chunk_scratch_floats.argtypes = [_I] * 5
    lib.stream_chunk_scratch_floats.restype = ctypes.c_size_t
    lib.rhs_launch.argtypes = [_I] + [_P] * 12 + [_I] * 10 + [ctypes.c_double, _P]  # B10
    lib.rhs_launch.restype = _I
    lib.rhs_smem_bytes.argtypes = [_I] * 6
    lib.rhs_smem_bytes.restype = ctypes.c_size_t
    lib.shard_stream_launch.argtypes = (  # B5 (ops/shard_stream.py)
        [_I] + [_P] * 12 + [_I] + [_P] * 3 + [_I] * 7 + [_F] * 2 + [_P]
    )
    lib.shard_stream_launch.restype = _I
    lib.shard_chunk_launch.argtypes = (  # B6 (ops/shard_chunk.py)
        [_I, _I] + [_P] * 7 + [_I] + [_P] * 9 + [_I] + [_P] * 3 + [_I] * 7 + [_F] * 4 + [_P]
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


def raise_for(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.stream_chunk_error_string(rc).decode())


def stream_chunk_cuda(state, spec: StreamSpec, chunk_steps: int):
    """Launch B2 once on the current stream of the state's device, with a
    fresh tiled scratch buffer. Raises if the state is not what the kernel
    takes or if the launch is refused; never falls back."""
    global launches
    if spec.device.type != "cuda":
        raise ValueError(f"the stream chunk kernel runs on CUDA tensors, not {spec.device}")
    check_state(state, spec)
    B = state.v.shape[0]
    if B == 0 or chunk_steps == 0:
        return type(state)(*(t.clone() for t in state))
    lib, _ = load_library()
    out = [torch.empty_like(t) for t in state]
    R, nnz = launch_lanes(spec.lanes, B, spec.device), spec.occ_slot.numel()
    per_tile = stream_scratch_floats(spec.Np, spec.Mp, nnz, spec.fixed, R)
    scratch = torch.empty(n_tiles(B, R) * per_tile, dtype=torch.float32, device=spec.device)
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.stream_chunk_launch(
            *(t.data_ptr() for t in state),
            *(t.data_ptr() for t in out),
            spec.lit_code.data_ptr(), spec.occ_ptr.data_ptr(), spec.slot_pos.data_ptr(),
            spec.segments.data_ptr(), spec.segments.shape[0], scratch.data_ptr(), B, spec.Np, spec.Mp, spec.K, nnz, int(chunk_steps),
            int(spec.fixed), int(spec.paper), int(spec.bf16),
            R, lane_threads(R, spec.Np, spec.Mp),
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
