"""The single-step ODE right-hand side (kernel B10): a hand-written CUDA
kernel for Hopper and its plain torch version, the kernel-order RHS.

Replaces the TPU kernel ``odesat_tpu/ops/rhs_pallas.py::make_pallas_rhs``
(Pallas; call :172), reached by ``dv_strategy="pallas"``: one RHS pass
``(v, xs, xl) -> (dv, dxs, dxl, allsat)`` for a batch, in float32 or
float64, which the step function of ``models/ode.py`` integrates.

Design for the card (``rhs_launch`` in ``csrc/stream_chunk.cu``, namespace
``rhs``): a CTA works on a tile of R trajectories, a trajectory on one lane
of each group of R threads, as B1 runs them, so every table word and every
clause's slots serve R trajectories. The TPU kernel gathers ``v`` and
scatters dv with matmuls against a stacked one-hot ``(K*Np, Mp)``, because
the TPU gathers poorly; here the tile's state sits in shared memory a row a
trajectory, each row whole 16-byte units and strided so that a lane
group's words of one item fall on distinct banks (R ≤ 8,
:func:`row_stride`), and the rows arrive and leave as 1D bulk copies
(``csrc/bulk.cuh``): one thread issues a copy a row and the rest wait on
an mbarrier, so the row-major ``(B, .)`` state is read and written
coalesced without the threads spending an instruction on a word of it.
The clause phase (groups over clauses, by width segment,
:func:`clause_segments`) takes the running top-2 min in slot order and
writes each slot's contribution, factored as B1 factors it, at its
occurrence's CSR position (:func:`slot_positions`); dxs and dxl overwrite
xs and xl; the lane's unsatisfied flag folds by ballot. The variable phase
sums each variable's CSR list (B1's, by clause, then slot) in four partial
sums, list positions 0-3 mod 4, added as (s0 + s1) + (s2 + s3), over
``v`` in place. No float atomics; built with ``--fmad=false``.

Two forms (:func:`rhs_plan`): *resident*, where a tile fits with two row
buffers (:func:`rhs_smem_bytes`): a persistent CTA walks its tiles, the
next tile's rows landing while this one is computed, the contributions in
shared memory; *streamed*: a CTA a tile, only v and a window of C clauses'
xs and xl in shared memory, the clause axis in windows of C and the
contributions in a device scratch, ``(nnz, R)`` a tile. The plan takes the
most lanes with which four CTAs of 256 threads share an SM, else two or one
CTA of 512 (phase 17 of ``chip_smoke.py`` chose the rule). The gate is the streamed form at R = 1:
``v`` of one trajectory and a window of one clause, up to 58,096 padded
variables in float32 and 29,048 in float64.

What bounds it: device-memory bytes, every one a row read or a row write
(the tables, about 5.5 KB at hard.cnf, are read once a tile through L2).

The plain version (:func:`rhs_plain`) is B1's RHS pass,
``ops/fused_chunk.py::_rhs_plain``, over B10's tables with dv in the
kernel's four partial sums: the same operations in the same order, so on
the card B10 equals it bit for bit, in float32 and float64. The twin's
``gather`` RHS (:func:`rhs_twin`) stays the reference for the JAX
semantics, to a tolerance (the two sum in other orders). Unit clauses are
rejected, as ``rhs_pallas.py:74-78`` rejects them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays
from odesat_tpu_torch.ops import rhs as rhs_ops
from odesat_tpu_torch.ops.fused_chunk import (
    SMEM_LIMIT_BYTES,
    _rhs_plain,
    cached_tables,
    chunk_tables,
    clause_segments,
    cuda_device,
    launch_lanes,
    plain_tables,
)
from odesat_tpu_torch.ops.stream_chunk import load_library, raise_for, slot_positions
from odesat_tpu_torch.ops.tiles import n_tiles

# Kernel launches made through rhs_cuda in this process (see
# ops/fused_chunk.py's counter).
launches = 0

_ITEMSIZE = {torch.float32: 4, torch.float64: 8}
HEAD_BYTES = 32  # two mbarriers and two unsat masks (csrc rhs::kHeadBytes)
MAX_RHS_LANES = 8  # the most lanes whose words of one item fall on distinct banks (rhs::kMaxLanes)
MIN_WINDOW = 32  # clauses a streamed window holds at least where R > 1


def row_stride(n: int, itemsize: int, lanes: int) -> int:
    """Elements a row of ``n`` takes in the tile (``rhs::row_stride``):
    whole 16-byte units (the bulk copies' unit) and, where R > 1, 16 bytes
    past a multiple of 128, so that the R words a lane group reads of one
    item fall on distinct banks."""
    nbytes = -(-n * itemsize // 16) * 16
    if lanes > 1:
        nbytes += (16 - nbytes % 128) % 128
    return nbytes // itemsize


def rhs_smem_bytes(Np: int, window: int, nnz: int, itemsize: int, lanes: int,
                   resident: bool) -> int:
    """Shared memory of one CTA, as ``csrc/stream_chunk.cu`` carves it
    (``rhs_smem_bytes``): the barriers and flags, then a row a trajectory
    of v and of the xs and xl of a window of ``window`` clauses; resident,
    two such buffers (the next tile's rows land while this one is computed)
    and a row of contributions."""
    state = row_stride(Np, itemsize, lanes) + 2 * row_stride(window, itemsize, lanes)
    row = 2 * state + row_stride(nnz, itemsize, lanes) if resident else state
    return HEAD_BYTES + itemsize * lanes * row


@dataclass(frozen=True)
class RhsPlan:
    """How a launch lays a tile out: ``lanes`` trajectories a CTA of
    ``threads`` threads, resident or streamed in windows of ``window``
    clauses (Mp when resident)."""

    lanes: int
    resident: bool
    window: int
    smem_bytes: int
    threads: int


SM_SHARED_BYTES = 233472  # the 228 KB of shared memory an H100 SM holds, 1 KB of it a CTA's


def widest_window(Np: int, itemsize: int, lanes: int, limit: int = SMEM_LIMIT_BYTES) -> int:
    """The most clauses a streamed window can hold beside v (0: none)."""
    room = (limit - rhs_smem_bytes(Np, 0, 0, itemsize, lanes, False)) // (2 * itemsize * lanes)
    C = max(0, room)
    while C > 0 and row_stride(C, itemsize, lanes) > room:
        C -= 1
    return C


def rhs_plan(Np: int, Mp: int, nnz: int, itemsize: int, lanes: Optional[int] = None,
             resident: Optional[bool] = None, window: Optional[int] = None,
             limit: int = SMEM_LIMIT_BYTES) -> Optional[RhsPlan]:
    """The resident form where its rows are whole 16-byte units: the most
    lanes (up to :data:`MAX_RHS_LANES`) with which four CTAs of 256 threads
    share an SM, else two or one of 512 (the rule phase 17's times chose:
    several tiles in flight an SM hide each other's loads).
    Else the streamed form at the most lanes whose window holds
    :data:`MIN_WINDOW` clauses (any at R = 1), the window whole 16-byte
    units, 512 threads. None past the gate. ``lanes``, ``resident`` and
    ``window`` force a choice (the tests and ``chip_smoke.py`` try every
    one)."""
    tries = [lanes] if lanes else [MAX_RHS_LANES >> s for s in range(MAX_RHS_LANES.bit_length())]
    unit = 16 // itemsize
    if resident is not False and Np % unit == 0 and Mp % unit == 0 and (window or Mp) >= Mp:
        fits = [(R, rhs_smem_bytes(Np, Mp, nnz, itemsize, R, True)) for R in tries]
        for share in (4, 2, 1):
            room = min(limit, SM_SHARED_BYTES // share - 1024)
            shared = [(R, nbytes) for R, nbytes in fits if nbytes <= room]
            if shared:
                R, nbytes = shared[0]
                return RhsPlan(R, True, Mp, nbytes, 256 if share == 4 else 512)
    if resident:
        return None
    for R in tries:
        room = widest_window(Np, itemsize, R, limit)
        C = min(Mp, room if window is None else window)
        if window is None and unit <= C < Mp:
            C -= C % unit
        if 1 <= C <= room and (window is not None or R == 1 or C >= min(Mp, MIN_WINDOW)):
            return RhsPlan(R, False, C, rhs_smem_bytes(Np, C, nnz, itemsize, R, False), 512)
    return None


def rhs_lane_range(Np: int, Mp: int, nnz: int, itemsize: int, resident: bool) -> list:
    """Every R (most first) at which the form fits: the plans the tests
    and ``chip_smoke.py`` hold the kernel to."""
    return [R for R in (MAX_RHS_LANES >> s for s in range(MAX_RHS_LANES.bit_length()))
            if rhs_plan(Np, Mp, nnz, itemsize, R, resident) is not None]


def nnz_of(fa: FormulaArrays) -> int:
    return int((fa.lit_mask > 0).sum())


def rhs_supported(fa: FormulaArrays, dtype: str = "float32") -> bool:
    """B10's gate: no unit clauses, and a plan that fits one CTA (at worst
    the streamed form at one trajectory)."""
    itemsize = 8 if dtype == "float64" else 4
    return fa.min_width >= 2 and rhs_plan(fa.n_vars_padded, fa.n_clauses_padded, nnz_of(fa),
                                          itemsize) is not None


@dataclass(frozen=True)
class RhsSpec:
    """One formula's B10 tables on one device, and what the plain version
    reads (``_rhs_plain`` and ``plain_tables``)."""

    device: torch.device
    lit_code: torch.Tensor  # (K*Mp,) int32
    occ_ptr: torch.Tensor  # (Np+1,) int32
    occ_slot: torch.Tensor  # (nnz,) int32, the plain version's CSR lists
    slot_pos: torch.Tensor  # (K*Mp,) int32, the CSR position of each slot
    segments: torch.Tensor  # (nseg, 4) int32, clause_segments
    clause_on: torch.Tensor  # (Mp,) bool
    K: int
    Mp: int
    Np: int
    zeta: float
    paper: bool
    bf16: bool = False  # B10 has no bf16 rounding; the plain version reads the flag

    @property
    def nnz(self) -> int:
        return int(self.occ_slot.numel())


def rhs_spec(fa: FormulaArrays, zeta: float, rigidity: str, device) -> RhsSpec:
    device = cuda_device(device)
    t = chunk_tables(fa)

    def put(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return RhsSpec(device, put(t.lit_code), put(t.occ_ptr), put(t.occ_slot),
                   put(slot_positions(t)), put(clause_segments(fa)),
                   put(fa.clause_mask > 0, torch.bool), t.K, t.Mp, t.Np, float(zeta),
                   rigidity == "paper")


def rhs_plain(v, xs, xl, spec: RhsSpec):
    """The kernel-order RHS on any device: B1's pass (``_rhs_plain``) over
    the spec's tables, in the state's dtype, dv in B10's four partial sums."""
    return _rhs_plain(v, xs, xl, spec, cached_tables(spec, plain_tables), partial_sums=4)


def rhs_twin(v, xs, xl, dev, zeta: float, rigidity: str, bucket_slices):
    """The twin's ``gather`` RHS over the formula tensors ``dev`` (a
    ``models.ode.FormulaDevice`` on the state's device): the JAX semantics,
    which B10 meets to a tolerance."""
    return rhs_ops.compute_derivatives(
        v, xs, xl,
        lit_var=dev.lit_var, sign=dev.sign, lit_mask=dev.lit_mask,
        clause_mask=dev.clause_mask, var_occ=dev.var_occ, occ_mask=dev.occ_mask,
        zeta=zeta, rigidity=rigidity, dv_strategy="gather", bucket_slices=bucket_slices,
    )


def launch_plan(spec: RhsSpec, B: int, dtype) -> RhsPlan:
    """The plan one launch of ``B`` trajectories takes: :func:`rhs_plan`'s;
    a streamed plan (a CTA a tile) has its R halved by ``launch_lanes``
    where the last wave of tiles would idle the card (a resident launch
    walks its tiles with as many CTAs as the card holds). Raises past the
    gate."""
    itemsize = _ITEMSIZE[dtype]
    plan = rhs_plan(spec.Np, spec.Mp, spec.nnz, itemsize)
    if plan is None:
        raise ValueError(f"the RHS kernel cannot hold {spec.Np} padded variables of {dtype} "
                         "in one CTA's shared memory")
    if not plan.resident:
        R = launch_lanes(plan.lanes, B, spec.device)
        if R != plan.lanes:
            plan = rhs_plan(spec.Np, spec.Mp, spec.nnz, itemsize, R, False)
    return plan


def rhs_cuda(v, xs, xl, spec: RhsSpec, plan: Optional[RhsPlan] = None):
    """Launch B10 once on the current stream of the state's device; returns
    (dv, dxs, dxl, allsat). ``plan`` (default :func:`launch_plan`'s) lays
    the tiles out; the tests and ``chip_smoke.py`` pass each one
    :func:`rhs_plan` forms. Raises if the inputs are not what the kernel
    takes or if the launch is refused; never falls back."""
    global launches
    if spec.device.type != "cuda":
        raise ValueError(f"the RHS kernel runs on CUDA tensors, not {spec.device}")
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
    if plan is None:
        plan = launch_plan(spec, B, dtype)
    R = plan.lanes
    scratch = None if plan.resident else torch.empty(n_tiles(B, R) * spec.nnz * R, dtype=dtype,
                                                     device=spec.device)
    lib, _ = load_library()
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.rhs_launch(
            int(dtype == torch.float64), v.data_ptr(), xs.data_ptr(), xl.data_ptr(),
            dv.data_ptr(), dxs.data_ptr(), dxl.data_ptr(), allsat.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            spec.lit_code.data_ptr(), spec.occ_ptr.data_ptr(), spec.slot_pos.data_ptr(),
            spec.segments.data_ptr(), spec.segments.shape[0], B, spec.Np, spec.Mp, spec.nnz,
            R, plan.window, int(plan.resident), plan.threads,
            int(spec.paper), spec.zeta, stream,
        )
    raise_for(lib, rc, "RHS kernel")
    launches += 1
    return dv, dxs, dxl, allsat


def make_rhs_kernel(fa: FormulaArrays, zeta: float, rigidity: str = "paper",
                    dtype: str = "float32"):
    """Build ``fn(v, xs, xl, dev=None) -> (dv, dxs, dxl, allsat)``. CUDA
    inputs go through B10, CPU inputs through :func:`rhs_plain` (the
    tables are moved to a device at its first use); anything else raises.
    ``dev`` is accepted for the step function's signature and ignored.
    Raises ValueError for unit clauses and past the gate."""
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
    specs = {}

    def fn(v, xs, xl, dev=None):
        kind = v.device.type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"no RHS kernel path for tensors on {v.device}")
        spec = specs.get(v.device)
        if spec is None:
            spec = specs[v.device] = rhs_spec(fa, zeta, rigidity, v.device)
        if kind == "cuda":
            return rhs_cuda(v, xs, xl, spec)
        return rhs_plain(v, xs, xl, spec)

    return fn
