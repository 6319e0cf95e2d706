"""The stochastic engine's kernels for Hopper: the chunk kernels B3 and B4
and the one plain torch version of what both compute, and below them the
clause mesh's B8 (one shard's evaluation) and B9 (the clause-sharded
chunk's launches), each with its plain version.

B3 replaces ``odesat_tpu/ops/stoch_pallas.py::make_fused_stoch_chunk``
(Pallas; kernel body :134-211), B4 replaces ``make_stream_stoch_chunk``
(kernel :394-503). Like them, one launch advances every chain
``chunk_steps`` steps of clause-weighted local search with the chain's
state held on chip (reference semantics: src/stoch.rs:26-78).

Design for the card (``csrc/stoch_chunk.cu``, ``stoch_lanes_kernel``):
one CTA runs a tile of R chains for the whole chunk, a chain on one lane
of each of its thread groups. The tile's ``v`` (bytes) and ``xl`` (int32)
live in shared memory interleaved ``[x][r]``, so every table word a group
reads serves R chains and every access to a chain's state is R
neighbouring elements. B3 also copies the formula's index tables there
once a CTA (a literal code per ``(k, m)`` slot and a CSR list of each
variable's clauses, built by ``ops/fused_chunk.chunk_tables``); B4 reads
them from global memory, where they stay in L2, so its footprint is the
chains' state alone. The TPU kernels' polarity-baked one-hot planes and
their matmuls exist because the TPU gathers poorly; here every step is a
clause phase (sat, weight update; the clause axis walked by width bucket,
``clause_segments``) and a variable phase (weight sums over the CSR list
in a fixed order, the counter-hash uniform, the flip; the variables taken
longest list first, :func:`var_order`), with no float atomics. Done is a
per-lane fact: a done lane writes nothing, and a tile leaves its loop when
every lane is done.

What bounds them: instruction issue and the latency of the gathers, plus,
for B4, L2 reads of the tables (one for R chains); not device memory,
which the state crosses once a chunk. R (:func:`stoch_lanes`) is the
largest power of two up to 32 whose footprint
(:func:`stoch_fused_smem_bytes`, :func:`stoch_stream_smem_bytes`) fits
one CTA's 227 KB, in place of the TPU's 8 MiB VMEM and plane budgets;
the gates are R = 1, where the footprints are the one-CTA-a-chain
kernels' own. A launch halves R where the last wave of tiles would leave
the card idle (``ops/fused_chunk.launch_lanes``). Unlike the ODE kernels,
both take unit clauses.

Bit-exactness: the weights are integers, so every f32 summation order
agrees while a variable's total stays below 2**24; within that envelope
the kernels, :func:`stoch_chunk_plain` and the Pallas kernels agree flip
for flip (bf16 mode rounds each weight to bf16, as the TPU kernels' bf16
matmul operands do). Beyond it the kernels still equal the plain version,
which sums in their CSR order.

The PRNG is the TPU kernels' counter hash (``_make_uniform01``,
stoch_pallas.py:42-67) over (seed, block, step, row, column) under the
Pallas chain blocking (:func:`traj_block`), reproduced bit for bit by
:func:`uniform01` in int64 torch arithmetic.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays
from odesat_tpu_torch.constants import STOCH_ALPHA
from odesat_tpu_torch.ops import _cuda
from odesat_tpu_torch.ops.fused_chunk import (
    LANE_THREADS,
    SMEM_LIMIT_BYTES,
    ChunkTables,
    cached_tables,
    chunk_tables,
    clause_segments,
    cuda_device,
    largest_lanes,
    launch_lanes,
    sm_count,
)
from odesat_tpu_torch.ops.tiles import TILE, rows_of, tile, untile

XL_CAP = 2**24
_MASK = 0xFFFFFFFF

# Kernel launches made through stoch_fused_cuda (B3) and stoch_stream_cuda
# (B4) in this process. Plain integers that callers may reset;
# chip_smoke.py reads them to show that the main path went through the
# kernels.
fused_launches = 0
stream_launches = 0


def traj_block(B: int, traj_block: int = 512) -> int:
    """The Pallas kernels' chain block (stoch_pallas.py:217-219): it sets
    each chain's block index and row in the PRNG."""
    Bb = traj_block
    while Bb > 8 and Bb > B:
        Bb //= 2
    return Bb


def _flag_words(lanes: int) -> int:
    """Shared words of the lane flags (``flag_words`` in the kernel): two
    masks by step parity, none for one lane, whose flag rides the barrier."""
    return 2 if lanes > 1 else 0


def lanes_smem_bytes(resident: bool, Np: int, Mp: int, K: int, nnz: int, lanes: int) -> int:
    """Shared memory of one CTA of B3 (``resident``) or B4 at ``lanes``
    chains, word for word the carve-up of ``csrc/stoch_chunk.cu`` (its
    ``lanes_smem_bytes``): the lane flags, B3's tables (literal codes, CSR
    pointers and clause lists), then per chain xl (4 bytes) and v (a byte).
    At one chain it is the one-CTA-a-chain kernels' footprint."""
    tables = K * Mp + (Np + 1) + nnz if resident else 0
    return 4 * (_flag_words(lanes) + tables + lanes * Mp) + lanes * Np


def stoch_fused_smem_bytes(fa: FormulaArrays, lanes: int = 1) -> int:
    """B3's shared memory per CTA at ``lanes`` chains (the kernel's
    ``stoch_fused_smem_bytes`` computes the same)."""
    K, Mp = fa.lit_var.shape
    return lanes_smem_bytes(True, fa.n_vars_padded, Mp, K, int((fa.lit_mask > 0).sum()), lanes)


def stoch_stream_smem_bytes(fa: FormulaArrays, lanes: int = 1) -> int:
    """B4's shared memory per CTA at ``lanes`` chains
    (``stoch_stream_smem_bytes``): the tables stay in global memory."""
    return lanes_smem_bytes(False, fa.n_vars_padded, fa.n_clauses_padded, 0, 0, lanes)


def stoch_lanes(fa: FormulaArrays, kernel: str) -> Optional[int]:
    """The chains one CTA of ``kernel`` ("fused": B3, "stream": B4) takes:
    the largest power of two up to 32 whose footprint fits, None past the
    gate."""
    footprint = {"fused": stoch_fused_smem_bytes, "stream": stoch_stream_smem_bytes}[kernel]
    return largest_lanes(lambda lanes: footprint(fa, lanes))


def stoch_fused_supported(fa: FormulaArrays) -> bool:
    """B3's gate: formula tables and one chain's state fit one CTA."""
    return stoch_lanes(fa, "fused") is not None


def stoch_stream_supported(fa: FormulaArrays) -> bool:
    """B4's gate: one chain's state fits one CTA (up to ~58k padded clauses
    at Np=128)."""
    return stoch_lanes(fa, "stream") is not None


SM_SHARED_BYTES = 233472  # shared memory of an H100 SM; each CTA also reserves 1 KB of it


def stoch_threads(lanes: int, smem: int, tiles: int, sms: int, Np: int, Mp: int) -> int:
    """Threads a CTA of B3 and B4: 1024 where one CTA's ``smem`` bytes leave
    no room for a second on an SM, or the tiles are no more than the
    ``sms`` (a tile has an SM to itself), else 512, so that CTAs share an
    SM and each thread's fixed work a step is paid by fewer threads; and
    never so many that a thread group gets fewer than four clauses.
    ``chip_smoke.py`` phase 11 times each side of the rule (PERF.md
    §6)."""
    alone = SM_SHARED_BYTES // (smem + 1024) <= 1 or tiles <= sms
    four_each = max(32, lanes * max(Np, Mp) // 4 // 32 * 32)
    return min(LANE_THREADS if alone else LANE_THREADS // 2, four_each)


def var_order(t: ChunkTables) -> np.ndarray:
    """(Np,) int32, the order in which B3's and B4's thread groups take the
    variables: longest occurrence list first, ties by index. A warp's groups
    take neighbouring positions, so their lists are about as long, and the
    kernel's snake over the rounds evens out the groups' totals."""
    return np.argsort(-np.diff(t.occ_ptr), kind="stable").astype(np.int32)


def position_lists(t: ChunkTables, order: np.ndarray) -> tuple:
    """The occurrence lists in the order B3's and B4's groups walk them:
    ``(ptr (Np+1,), clauses (nnz,))`` int32, position p's list being
    variable ``order[p]``'s clause columns in their CSR order, so a group
    reads a position's list bounds without first reading its variable."""
    counts = np.diff(t.occ_ptr)[order]
    ptr = np.zeros(t.Np + 1, dtype=np.int32)
    np.cumsum(counts, out=ptr[1:])
    src = np.repeat(t.occ_ptr[order] - ptr[:-1], counts) + np.arange(ptr[-1])
    return ptr, (t.occ_slot[src] % t.Mp).astype(np.int32)


@dataclass(frozen=True)
class StochSpec:
    """One formula's kernel tables on one device."""

    device: torch.device
    lit_code: torch.Tensor  # (K*Mp,) int32, 2*var + negated, -1 at padding
    occ_ptr: torch.Tensor  # (Np+1,) int32
    occ_clause: torch.Tensor  # (nnz,) int32 clause column of each occurrence
    K: int
    Mp: int
    Np: int


@dataclass(frozen=True)
class StochChunkSpec(StochSpec):
    """A :class:`StochSpec` (what the plain version reads) plus what B3 and
    B4 read beside it, and the chains a CTA of each takes (None past its
    gate)."""

    var_order: torch.Tensor  # (Np,) int32, var_order
    pos_ptr: torch.Tensor  # (Np+1,) int32, position_lists
    pos_clause: torch.Tensor  # (nnz,) int32
    segments: torch.Tensor  # (nseg, 4) int32, clause_segments
    fused_lanes: Optional[int]
    stream_lanes: Optional[int]


def stoch_spec(fa: FormulaArrays, device) -> StochChunkSpec:
    """Build the kernels' tables from the formula and move them to
    ``device``. The occurrence lists are ``chunk_tables``' (variable, then
    clause, then slot order) mapped from slots to clause columns."""
    device = cuda_device(device)
    t = chunk_tables(fa)
    order = var_order(t)
    pos_ptr, pos_clause = position_lists(t, order)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return StochChunkSpec(
        device=device,
        lit_code=put(t.lit_code),
        occ_ptr=put(t.occ_ptr),
        occ_clause=put(t.occ_slot % t.Mp),
        K=t.K,
        Mp=t.Mp,
        Np=t.Np,
        var_order=put(order),
        pos_ptr=put(pos_ptr),
        pos_clause=put(pos_clause),
        segments=put(clause_segments(fa)),
        fused_lanes=stoch_lanes(fa, "fused"),
        stream_lanes=stoch_lanes(fa, "stream"),
    )


# ---------------------------------------------------------------- plain


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): split into 16-bit
    halves, so no int64 product overflows."""
    lo = x & 0xFFFF
    hi = x >> 16
    return ((((hi * c) & _MASK) << 16) + lo * c) & _MASK


def _hash_uniform(seed: int, chains: torch.Tensor, cols: torch.Tensor, Bb: int,
                  step: int) -> torch.Tensor:
    """The counter-hash uniforms of chains ``chains`` and variable columns
    ``cols`` (int64 tensors that broadcast together) at launch-local
    ``step``, f32 in [0, 1), in their broadcast shape."""
    blk = chains // Bb
    r = chains % Bb
    block_seed = (int(seed) + _mul32(blk, 0x632BE59B)) & _MASK
    base = (block_seed + _mul32(torch.full_like(blk, int(step)), 0xC2B2AE3D)) & _MASK
    # the per-chain terms meet first, so one pass at the full shape joins the columns
    x = (_mul32(r, 0x9E3779B1) ^ base) ^ _mul32(cols, 0x85EBCA77)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniform01(seed: int, chains: torch.Tensor, Bb: int, step: int, Np: int) -> torch.Tensor:
    """The counter-hash uniforms (B, Np) f32 in [0, 1) of ``_make_uniform01``
    for chains ``chains`` (int64 global indices) at launch-local ``step``."""
    cols = torch.arange(Np, device=chains.device, dtype=torch.int64)
    return _hash_uniform(seed, chains.unsqueeze(1), cols.unsqueeze(0), Bb, step)


def uniform01_tiled(seed: int, G: int, Bb: int, step: int, Np: int, device) -> torch.Tensor:
    """:func:`uniform01` of chains ``0 .. G*TILE-1`` drawn in tile order,
    ``(G, Np, TILE)``: the chain ids shaped ``(G, 1, TILE)``, the columns
    ``(1, Np, 1)``. Equal to ``tile(uniform01(...))`` on the real chains;
    a ragged last tile's padding lanes draw as the chains of their index."""
    chains = torch.arange(G * TILE, device=device, dtype=torch.int64).view(G, 1, TILE)
    cols = torch.arange(Np, device=device, dtype=torch.int64).view(1, Np, 1)
    return _hash_uniform(seed, chains, cols, Bb, step)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)  # round to nearest even


class PlainTables(NamedTuple):
    """The kernels' tables decoded for tensor ops."""

    lit_var: torch.Tensor  # (K, Mp) int64, 0 at padding
    negated: torch.Tensor  # (K, Mp) bool
    lit_on: torch.Tensor  # (K, Mp) bool
    clause_on: torch.Tensor  # (Mp,) bool
    occ_pad: torch.Tensor  # (Np, D) int64, padded with Mp (a column that is always 0)
    has_occ: torch.Tensor  # (Np,) bool


def plain_tables(spec: StochSpec) -> PlainTables:
    """Decode the kernels' tables for the plain version (the clause mask
    is "slot 0 holds a literal": a real clause is never empty)."""
    code = spec.lit_code.long().view(spec.K, spec.Mp)
    on = code >= 0
    ptr = spec.occ_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    D = max(int(counts.max()), 1)
    var = torch.repeat_interleave(torch.arange(spec.Np, device=ptr.device), counts)
    rank = torch.arange(var.numel(), device=ptr.device) - ptr[var]
    pad = torch.full((spec.Np, D), spec.Mp, dtype=torch.long, device=ptr.device)
    pad[var, rank] = spec.occ_clause.long()
    return PlainTables(torch.where(on, code >> 1, 0), on & (code & 1).bool(), on, on[0],
                       pad, counts > 0)


def _sums(w: torch.Tensor, occ_pad: torch.Tensor) -> torch.Tensor:
    """Per-variable sums of the per-clause weights ``w`` (B, Mp) over the
    occurrence lists, one occurrence at a time in CSR order, as the
    kernels sum."""
    flat = torch.cat([w, w.new_zeros(w.shape[0], 1)], dim=1)
    picked = flat[:, occ_pad]  # (B, Np, D)
    out = torch.zeros(picked.shape[:2], dtype=w.dtype, device=w.device)
    for d in range(picked.shape[-1]):
        out = out + picked[:, :, d]
    return out


def stoch_chunk_plain(state, spec: StochSpec, chunk_steps: int, seed: int, Bb: int,
                      bf16: bool):
    """``chunk_steps`` steps of the kernels' arithmetic in torch ops, on
    any device (stoch_pallas.py:147-204): sat from the pre-flip v; the
    weight update; f32 total and unsat sums of the post-update weights
    (each rounded to bf16 first when ``bf16``); ``flip = u*total < unsat``
    for variables in some clause; done rows keep v and xl; done latches
    from the pre-flip allsat."""
    t = plain_tables(spec)
    v, xl, done = state.v, state.xl, state.done
    chains = torch.arange(v.shape[0], device=v.device, dtype=torch.int64)
    for step in range(chunk_steps):
        lit_true = (v[:, t.lit_var] != t.negated) & t.lit_on  # (B, K, Mp)
        sat = lit_true.any(dim=1)
        xl_new = torch.where(sat, (xl - 1).clamp_min(1), (xl + STOCH_ALPHA).clamp_max(XL_CAP))
        xl_new = torch.where(t.clause_on, xl_new, 0)
        w = xl_new.to(torch.float32)
        if bf16:
            w = _bf16(w)
        total = _sums(w, t.occ_pad)
        unsat = _sums(torch.where(sat, 0.0, w), t.occ_pad)
        u = uniform01(seed, chains, Bb, step, spec.Np)
        flip = (u * total < unsat) & t.has_occ
        active = ~done
        all_sat = (sat | ~t.clause_on).all(dim=1)
        v = torch.where(active.unsqueeze(1) & flip, ~v, v)
        xl = torch.where(active.unsqueeze(1), xl_new, xl)
        done = done | all_sat
    return state._replace(v=v, xl=xl, done=done)


# ---------------------------------------------------------------- kernels

_P = ctypes.c_void_p
_I = ctypes.c_int


def _declare(lib) -> None:
    for name in ("stoch_fused_launch", "stoch_stream_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 11 + [_I] * 7 + [ctypes.c_uint] + [_I] * 4 + [_P]
        fn.restype = _I
    lib.stoch_fused_smem_bytes.argtypes = [_I] * 5
    lib.stoch_fused_smem_bytes.restype = ctypes.c_size_t
    lib.stoch_stream_smem_bytes.argtypes = [_I] * 3
    lib.stoch_stream_smem_bytes.restype = ctypes.c_size_t
    lib.stoch_shard_eval_launch.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.stoch_shard_eval_launch.restype = _I
    lib.stoch_shard_step_launch.argtypes = (
        [_P] * 4 + [_I] + [_P] * 5 + [_I] * 7 + [ctypes.c_uint] + [_I] * 4 + [_P]
    )
    lib.stoch_shard_step_launch.restype = _I
    lib.stoch_chunk_error_string.argtypes = [_I]
    lib.stoch_chunk_error_string.restype = ctypes.c_char_p


def load_library():
    """Build (at first use) and load both kernels. Returns ``(lib, build)``."""
    return _cuda.load("stoch_chunk", _declare)


def _check(state, spec: StochSpec) -> None:
    B = state.v.shape[0]
    want = {
        "v": ((B, spec.Np), torch.bool),
        "xl": ((B, spec.Mp), torch.int32),
        "done": ((B,), torch.bool),
    }
    for name, (shape, dtype) in want.items():
        t = getattr(state, name)
        if t.device != spec.device:
            raise ValueError(f"state.{name} is on {t.device}, the formula on {spec.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"state.{name} is {tuple(t.shape)} {t.dtype}; the kernel takes {shape} {dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"state.{name} is not contiguous")


def _launch(entry: str, state, spec: StochChunkSpec, chunk_steps: int, seed: int, bf16: bool,
            most: Optional[int], lanes: Optional[int]):
    """Launch ``entry`` at ``lanes`` chains a CTA (None: ``launch_lanes`` of
    ``most``, the kernel's largest R)."""
    if spec.device.type != "cuda":
        raise ValueError(f"the stoch chunk kernels run on CUDA tensors, not {spec.device}")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} is not a uint32")
    if most is None:
        raise ValueError(f"{entry}: one chain's state does not fit a CTA (shared-memory gate)")
    _check(state, spec)
    B = state.v.shape[0]
    R = launch_lanes(most, B, spec.device) if lanes is None else int(lanes)
    if not 1 <= R <= most or R & (R - 1):
        raise ValueError(f"{R} chains a CTA: {entry} takes a power of two up to {most}")
    smem = lanes_smem_bytes(entry == "stoch_fused_launch", spec.Np, spec.Mp, spec.K,
                            spec.occ_clause.numel(), R)
    threads = stoch_threads(R, smem, -(-B // R), sm_count(spec.device), spec.Np, spec.Mp)
    lib, _ = load_library()
    out = type(state)(*(torch.empty_like(t) for t in state))
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in state),
            *(t.data_ptr() for t in out),
            spec.lit_code.data_ptr(), spec.pos_ptr.data_ptr(), spec.pos_clause.data_ptr(),
            spec.var_order.data_ptr(), spec.segments.data_ptr(), spec.segments.shape[0],
            B, spec.Np, spec.Mp, spec.K, spec.occ_clause.numel(), int(chunk_steps),
            int(seed), traj_block(B), int(bf16), R, threads, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{entry} failed: " + lib.stoch_chunk_error_string(rc).decode()
        )
    return out


def stoch_fused_cuda(state, spec: StochChunkSpec, chunk_steps: int, seed: int, bf16: bool,
                     lanes: Optional[int] = None):
    """Launch B3 once on the current stream, ``lanes`` chains a CTA (None:
    the most that fit, halved for a ragged last wave). Raises if the state
    is not what it takes, the formula is past its gate, or the launch is
    refused."""
    global fused_launches
    if state.v.shape[0] == 0:
        return state
    out = _launch("stoch_fused_launch", state, spec, chunk_steps, seed, bf16, spec.fused_lanes,
                  lanes)
    fused_launches += 1
    return out


def stoch_stream_cuda(state, spec: StochChunkSpec, chunk_steps: int, seed: int, bf16: bool,
                      lanes: Optional[int] = None):
    """Launch B4 once on the current stream, ``lanes`` chains a CTA as
    :func:`stoch_fused_cuda` takes them. Raises if the state is not what it
    takes, one chain's state is past its gate, or the launch is refused."""
    global stream_launches
    if state.v.shape[0] == 0:
        return state
    out = _launch("stoch_stream_launch", state, spec, chunk_steps, seed, bf16,
                  spec.stream_lanes, lanes)
    stream_launches += 1
    return out


# ------------------------------------------ one clause shard's evaluation (B8)
#
# B8 replaces ``odesat_tpu/ops/stoch_pallas.py::make_stoch_shard_eval``
# (Pallas; call :814): on a clause mesh with ``--shard-chunk off`` each rank
# evaluates one step over its own clause segment; the caller all-reduces
# the (total, unsat) partial sums and the sat flag over the clause group and
# draws the flips in torch (parallel/sharded.py). The TPU kernel reused the
# ODE shard plan's sign-baked planes for matmul gathers and scatters; here a
# launch is B9's evaluation (below) without its flip prologue, over the
# chains tiled by ``TILE`` = 32 (``ops/tiles.py``): a tile's chains on the
# lanes of a warp, each table word (the shard plan's literal codes and local
# CSR, ops/shard_stream.py) read once for 32 chains, each gather a whole
# line, nothing of a chain in shared memory, the partials into one tiled
# (total | unsat | 1 - sat) buffer that the caller all-reduces as it is.
# What bounds it on the card: device-memory bytes (xl read and written, v
# read, the (B, 2*Np+1) partials written every step) and the gathers of the
# weights through L2. Its runner (parallel/sharded.make_clause_stoch_runner)
# keeps the chains tiled for a chunk.

shard_launches = 0  # B8 launches, as fused_launches counts B3's


def stoch_shard_arrays(fa: FormulaArrays) -> tuple:
    """Per shard of ``fa.shard_plan``, the tables B8 reads: ``(lit_code,
    occ_ptr, occ_clause)`` as int32 NumPy arrays. The port's counterpart of
    the TPU kernel's ``sbias``/``nsign`` companions (stoch_pallas.py:1199),
    which this design does not need."""
    return tuple((t.lit_code, t.occ_ptr, (t.occ_slot % t.Mp).astype(np.int32))
                 for t in fa.shard_plan.tables)


def stoch_shard_spec(fa: FormulaArrays, device, shard: int = 0) -> StochSpec:
    """Shard ``shard``'s B8 tables on ``device``."""
    device = cuda_device(device)
    t = fa.shard_plan.tables[shard]
    lit_code, occ_ptr, occ_clause = stoch_shard_arrays(fa)[shard]

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return StochSpec(device, put(lit_code), put(occ_ptr), put(occ_clause), t.K, t.Mp, t.Np)


def _check_tiled(spec: StochSpec, G: int, R: int, **tensors) -> None:
    """Raise ValueError unless every tiled buffer of B8 or B9 is on the
    spec's device, contiguous and of its shape and dtype."""
    want = dict(v=((G, spec.Np, R), torch.bool), xl=((G, spec.Mp, R), torch.int32),
                done=((G, R), torch.bool), acc=((G, 2 * spec.Np + 1, R), torch.float32),
                w=((G, spec.Mp, R), torch.int32))
    for name, x in tensors.items():
        shape, dtype = want[name]
        if (x.device != spec.device or tuple(x.shape) != shape or x.dtype != dtype
                or not x.is_contiguous()):
            raise ValueError(f"{name} is {tuple(x.shape)} {x.dtype} on {x.device}; the kernel "
                             f"takes a contiguous {shape} {dtype} on {spec.device}")


def stoch_shard_eval_plain(v, xl, active, spec: StochSpec, bf16: bool):
    """One step's evaluation over a shard, B8's arithmetic in torch ops:
    returns ``(total, unsat, xl_new, sat)``: the (B, Np) f32 partial weight
    sums of the post-update weights (each rounded to bf16 first when
    ``bf16``), the new weights (a frozen chain's unchanged) and the shard's
    all-satisfied flag (stoch_pallas.py:712-757)."""
    t = cached_tables(spec, plain_tables)
    lit_true = (v[:, t.lit_var] != t.negated) & t.lit_on  # (B, K, Mp)
    sat = lit_true.any(dim=1)
    xl_new = torch.where(sat, (xl - 1).clamp_min(1), (xl + STOCH_ALPHA).clamp_max(XL_CAP))
    xl_new = torch.where(t.clause_on, xl_new, 0)
    w = xl_new.to(torch.float32)
    if bf16:
        w = _bf16(w)
    total = _sums(w, t.occ_pad)
    unsat = _sums(torch.where(sat, 0.0, w), t.occ_pad)
    allsat = (sat | ~t.clause_on).all(dim=1)
    return total, unsat, torch.where(active.unsqueeze(1), xl_new, xl), allsat


def _partials(total, unsat, sat):
    """(total | unsat | 1 - sat), the buffer the clause group all-reduces."""
    return torch.cat([total, unsat, (~sat).to(total.dtype).unsqueeze(1)], dim=1)


def stoch_shard_eval_plain_tiled(v, xl, done, spec: StochSpec, bf16: bool):
    """:func:`stoch_shard_eval_plain` on tiled chains (a done chain is not
    active), as the kernel returns it: ``(xl, acc)`` tiled, acc = (total |
    unsat | 1 - sat). Untiled with the padding lanes, run, tiled again."""
    R, rows = v.shape[-1], rows_of(v)
    total, unsat, xl, sat = stoch_shard_eval_plain(untile(v, rows), untile(xl, rows),
                                                   ~untile(done, rows), spec, bf16)
    return tile(xl, R), tile(_partials(total, unsat, sat), R)


def stoch_shard_eval_cuda(v, xl, done, spec: StochSpec, bf16: bool, acc=None, w=None):
    """Launch B8 once on the current stream, on tiled chains (``TILE`` a
    tile): v (G, Np, R) bool, xl (G, Mp, R) int32 (updated in place where
    the chain is not done), done (G, R) bool; writes acc (G, 2*Np+1, R) f32
    = (total | unsat | 1 - sat) and returns ``(xl, acc)``. ``acc`` and the
    (G, Mp, R) int32 weight scratch ``w`` are allocated here when None.
    Raises if an input is not what it takes or the launch is refused; never
    falls back."""
    global shard_launches
    if spec.device.type != "cuda":
        raise ValueError(f"the stoch shard kernel runs on CUDA tensors, not {spec.device}")
    G, R = v.shape[0], v.shape[-1]
    if R != TILE:
        raise ValueError(f"tiles of {R} chains; the kernel takes {TILE}")
    if acc is None:
        acc = torch.empty((G, 2 * spec.Np + 1, R), dtype=torch.float32, device=spec.device)
    if w is None:
        w = torch.empty((G, spec.Mp, R), dtype=torch.int32, device=spec.device)
    _check_tiled(spec, G, R, v=v, xl=xl, done=done, acc=acc, w=w)
    if G == 0:
        return xl, acc
    lib, _ = load_library()
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.stoch_shard_eval_launch(
            v.data_ptr(), xl.data_ptr(), done.data_ptr(), acc.data_ptr(), w.data_ptr(),
            spec.lit_code.data_ptr(), spec.occ_ptr.data_ptr(), spec.occ_clause.data_ptr(),
            G, R, spec.Np, spec.Mp, spec.K, spec.occ_clause.numel(), int(bf16), stream,
        )
    if rc != 0:
        raise RuntimeError("stoch_shard_eval_launch failed: "
                           + lib.stoch_chunk_error_string(rc).decode())
    shard_launches += 1
    return xl, acc


def make_stoch_shard_eval(fa: FormulaArrays, device, shard: int = 0,
                          matmul_dtype: str = "float32"):
    """``eval(v, xl, active) -> (total, unsat, xl_new, sat)`` over shard
    ``shard`` of ``fa.shard_plan`` (JAX :605), on rows as they are: for
    CUDA tensors B8 on tiled copies, untiled again; for CPU tensors its
    plain version; anything else raises. v (B, Np) bool, xl (B, Mp_local)
    int32, active (B,) bool. ``eval.tiled(v, xl, done, acc=None, w=None) ->
    (xl, acc)`` is the same on tiled chains (a done chain is not active),
    what the runner calls: B8 (:func:`stoch_shard_eval_cuda`) for CUDA
    buffers, :func:`stoch_shard_eval_plain_tiled` for CPU buffers."""
    if fa.shard_plan is None:
        raise ValueError("needs a compile_stream_sharded formula (shard plan)")
    spec = stoch_shard_spec(fa, device, shard)
    bf16 = matmul_dtype == "bfloat16"

    def ev(v, xl, active):
        kind = v.device.type
        if kind == "cpu":
            return stoch_shard_eval_plain(v, xl, active, spec, bf16)
        if kind != "cuda":
            raise ValueError(f"no stoch shard path for tensors on {v.device}")
        _check(SimpleNamespace(v=v, xl=xl, done=active), spec)  # active checks as done does
        B, Np = v.shape[0], spec.Np
        xl_t, acc = stoch_shard_eval_cuda(tile(v), tile(xl, fill=1),
                                          tile(~active, fill=True), spec, bf16)
        return (untile(acc[:, :Np], B), untile(acc[:, Np:2 * Np], B), untile(xl_t, B),
                untile(acc[:, 2 * Np], B) == 0)

    def tiled(v, xl, done, acc=None, w=None):
        kind = v.device.type
        if kind == "cuda":
            return stoch_shard_eval_cuda(v, xl, done, spec, bf16, acc, w)
        if kind == "cpu":
            return stoch_shard_eval_plain_tiled(v, xl, done, spec, bf16)
        raise ValueError(f"no stoch shard path for tensors on {v.device}")

    ev.spec = spec
    ev.tiled = tiled
    return ev


# ------------------------------------ the clause-sharded stoch chunk (B9)
#
# B9 replaces ``odesat_tpu/ops/stoch_pallas.py::make_stoch_shard_chunk``
# (Pallas; call :1161), the whole-chunk clause-shard kernel that all-reduced
# the (total, unsat, sat) partials inside itself over ICI remote DMA (B7,
# ``odesat_tpu/ops/butterfly.py``). On Hopper the chunk is a launch per step
# of ``stoch_shard_step_launch`` (``csrc/stoch_chunk.cu``) and one more, and
# the all-reduce is fused into the launches that consume it: each launch
# applies the previous step's sums (the flip with the counter-hash uniforms
# of that step, the done latch), reading the S ranks' partials of that step
# (on a clause mesh its own slot and the peers' IPC-mapped slots, after a
# stream wait on their flags, ``ops/butterfly.py``) and adding them in the
# butterfly's tree as it reads them, then evaluates the shard for its own
# step as B8 does, into ``acc`` = (total | unsat | 1 - sat), this launch's
# slot. The flips and their uniforms, which B8's path draws in torch, run in
# the kernel. Same seed, blocking and step index as B8's path, so the two
# flip for flip; the sums are integers in f32, so any S flips as S=1 does.
# JAX's min-combined sat flag is a summed (1 - sat) here: 0 after the sum
# exactly when every shard is satisfied.
#
# Design: the runner tiles the chains once a chunk (``ops/tiles.py``,
# ``TILE`` = 32 chains a tile); a launch is a few kernels over (tile, span
# of clauses or variables) with a tile's chains on the lanes of a warp, so
# each table word is read once for 32 chains; the signed post-update
# weights go to a tiled int32 scratch allocated once a chunk, from which
# the variable sums gather.

shard_chunk_launches = 0  # B9 launches, as shard_launches counts B8's


def stoch_shard_supported(fa: FormulaArrays) -> bool:
    """B8's and B9's gate: a shard plan and a chain's v (bytes) within one
    CTA's shared memory, the need of the one-CTA-a-chain design the gate
    was written for, kept so that the same formulas take the kernels;
    neither tiled kernel holds a chain in shared memory. Unit clauses are
    fine."""
    return fa.shard_plan is not None and fa.n_vars_padded <= SMEM_LIMIT_BYTES


def stoch_shard_step_plain(v, xl, done, acc, spec: StochSpec, bf16: bool, seed: int, Bb: int,
                           t: int, apply: bool, evaluate: bool = True, parts=None):
    """One launch of B9 in torch ops, on (B, X) buffers: returns ``(v, xl,
    done, acc)`` as the kernel leaves them. ``parts``, the S ranks' partials
    (B, 2*Np+1) of step ``t - 1`` (rank order), summed in the butterfly's
    tree, are read when ``apply`` (None: ``acc`` holds the sums, a group of
    one); ``acc`` holds the shard's partials of step ``t`` on exit (when
    ``evaluate``)."""
    from odesat_tpu_torch.ops import butterfly as bf

    Np = spec.Np
    if apply:
        red = acc if parts is None else bf.combine_parts(list(parts))
        chains = torch.arange(v.shape[0], device=v.device, dtype=torch.int64)
        u = uniform01(seed, chains, Bb, t - 1, Np)
        flip = u * red[:, :Np] < red[:, Np:2 * Np]
        v = torch.where((~done).unsqueeze(1) & flip, ~v, v)
        done = done | (red[:, 2 * Np] == 0)
    if not evaluate:
        return v, xl, done, acc
    total, unsat, xl, sat = stoch_shard_eval_plain(v, xl, ~done, spec, bf16)
    return v, xl, done, _partials(total, unsat, sat)


def stoch_shard_step_plain_tiled(v, xl, done, acc, spec: StochSpec, bf16: bool, seed: int,
                                 Bb: int, t: int, apply: bool, evaluate: bool = True,
                                 parts=None):
    """:func:`stoch_shard_step_plain` on tiled buffers and tiled partials:
    untiled (padding rows kept, at their chain indices), run, tiled
    again."""
    R, rows = v.shape[-1], rows_of(v)
    out = stoch_shard_step_plain(*(untile(x, rows) for x in (v, xl, done, acc)), spec, bf16,
                                 seed, Bb, t, apply, evaluate,
                                 None if parts is None else [untile(p, rows) for p in parts])
    return tuple(tile(x, R) for x in out)


def stoch_shard_step_cuda(v, xl, done, acc, spec: StochSpec, bf16: bool, seed: int, Bb: int,
                          t: int, apply: bool, evaluate: bool = True, w=None, parts=None):
    """Launch B9 once on the current stream, on tiled buffers (``TILE``
    chains a tile): v (G, Np, R) bool, xl (G, Mp, R) int32, done (G, R)
    bool, acc (G, 2*Np+1, R) f32 (the partials written), updated in place
    and returned. ``parts``, the S ranks' (G, 2*Np+1, R) f32 partials of the
    previous step (rank order; the peers' slots on a clause mesh), are read
    when ``apply`` and summed in the butterfly's tree by the flip and head
    kernels as they read them (None: ``acc`` holds the sums, a group of
    one). ``w`` is the (G, Mp, R) int32 weight scratch (allocated here when
    None). Raises if an input is not what it takes or the launch is refused;
    never falls back."""
    global shard_chunk_launches
    from odesat_tpu_torch.ops import butterfly as bf

    if spec.device.type != "cuda":
        raise ValueError(f"the stoch shard chunk kernel runs on CUDA tensors, not {spec.device}")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} is not a uint32")
    G, R = v.shape[0], v.shape[-1]
    if R != TILE:
        raise ValueError(f"tiles of {R} chains; the kernel takes {TILE}")
    if w is None:
        w = torch.empty((G, spec.Mp, R), dtype=torch.int32, device=spec.device)
    parts = [acc] if parts is None else list(parts)
    _check_tiled(spec, G, R, v=v, xl=xl, done=done, acc=acc, w=w)
    red = bf.pointers(parts, acc.shape, spec.device)
    if G == 0:
        return v, xl, done, acc
    lib, _ = load_library()
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.stoch_shard_step_launch(
            v.data_ptr(), xl.data_ptr(), done.data_ptr(), red, len(parts), acc.data_ptr(),
            w.data_ptr(),
            spec.lit_code.data_ptr(), spec.occ_ptr.data_ptr(), spec.occ_clause.data_ptr(),
            G, R, spec.Np, spec.Mp, spec.K, spec.occ_clause.numel(), int(bf16), int(seed),
            int(Bb), int(t), int(apply), int(evaluate), stream,
        )
    if rc != 0:
        raise RuntimeError("stoch_shard_step_launch failed: "
                           + lib.stoch_chunk_error_string(rc).decode())
    shard_chunk_launches += 1
    if len(parts) > 1:
        bf.fused_launches += 1
    return v, xl, done, acc


def make_stoch_shard_chunk(fa: FormulaArrays, chunk_steps: int, device, shard: int = 0,
                           clause_group=None, matmul_dtype: str = "float32",
                           plain: bool = False):
    """``fn(state, seed) -> state`` advancing this rank's chains
    ``chunk_steps`` steps over shard ``shard`` of ``fa.shard_plan`` (JAX
    :868): B9's launches (CUDA states) or its plain version (CPU states),
    each reading the S ranks' partials of the step before over
    ``clause_group`` (``ops/butterfly.py``: on a card the peers' slots after
    a stream wait on their flags; on the CPU the partials gathered over the
    group; in a group of one its own), on the chains tiled once at entry and
    untiled once at exit. ``plain``: the plain version on any device, the
    partials gathered over the group (what the card's runs are held
    against). ``seed`` is the chunk's 31-bit PRNG seed, the same on every
    clause rank of a row. The caller's state is never written."""
    import torch.distributed as dist

    from odesat_tpu_torch.ops import butterfly as bf

    if not stoch_shard_supported(fa):
        raise ValueError("the clause-shard stoch kernels need a compile_stream_sharded "
                         "formula whose v fits one CTA")
    S = 1 if clause_group is None else dist.get_world_size(clause_group)
    if clause_group is not None and S != fa.shard_plan.n_shards:
        raise ValueError(f"the plan has {fa.shard_plan.n_shards} shards but the clause group "
                         f"{S} ranks")
    spec = stoch_shard_spec(fa, device, shard)
    bf16 = matmul_dtype == "bfloat16"

    def fn(state, seed: int):
        kind = state.v.device.type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"no stoch shard chunk path for tensors on {state.v.device}")
        B = state.v.shape[0]
        Bb = traj_block(B)
        v, xl, done = tile(state.v), tile(state.xl, fill=1), tile(state.done, fill=True)
        G = v.shape[0]
        shape = (G, 2 * spec.Np + 1, TILE)
        acc = torch.zeros(shape, dtype=torch.float32, device=v.device)
        comm = None
        if kind == "cuda" and not plain:
            w = torch.empty((G, spec.Mp, TILE), dtype=torch.int32, device=v.device)
            if S > 1:
                comm = bf.communicator(clause_group, v.device)
                comm.begin(shape)

            def launch(*args, **kw):
                return stoch_shard_step_cuda(*args, **kw, w=w)
        else:
            launch = stoch_shard_step_plain_tiled
        parts = None  # the S partials of the previous step
        for t in range(chunk_steps + 1):
            evaluate = t < chunk_steps
            if comm is not None:
                comm.wait()  # the peers' earlier launches are done
                if evaluate:
                    acc = comm.slot(shape)  # this launch's slot
            v, xl, done, acc = launch(v, xl, done, acc, spec, bf16, seed, Bb, t, apply=t > 0,
                                      evaluate=evaluate, parts=parts)
            if comm is not None:
                parts = comm.parts(shape)
                comm.signal()
            elif evaluate and S > 1:
                parts = [p.reshape(shape).to(v.device)
                         for p in bf.gather_plain(acc, clause_group)]
        return state._replace(v=untile(v, B), xl=untile(xl, B), done=untile(done, B))

    fn.spec = spec
    return fn


def make_stoch_chunk(fa: FormulaArrays, chunk_steps: int, kernel: str, matmul_dtype: str,
                     device):
    """Build ``fn(state, seed) -> state`` advancing every chain
    ``chunk_steps`` steps in one launch of ``kernel`` ("fused": B3,
    "stream": B4). CUDA states go through the kernel, CPU states (the
    tests) through :func:`stoch_chunk_plain`; anything else raises.
    ``seed`` is the launch's 31-bit PRNG seed."""
    supported = {"fused": stoch_fused_supported, "stream": stoch_stream_supported}[kernel]
    if not supported(fa):
        raise ValueError(f"stoch {kernel} kernel unsupported for this formula "
                         "(shared-memory gate); use the scan path")
    spec = stoch_spec(fa, device)
    bf16 = matmul_dtype == "bfloat16"
    launch = stoch_fused_cuda if kernel == "fused" else stoch_stream_cuda

    def fn(state, seed: int):
        kind = state.v.device.type
        if kind == "cuda":
            return launch(state, spec, chunk_steps, seed, bf16)
        if kind == "cpu":
            return stoch_chunk_plain(state, spec, chunk_steps, seed,
                                     traj_block(state.v.shape[0]), bf16)
        raise ValueError(f"no stoch chunk path for tensors on {state.v.device}")

    fn.spec = spec
    return fn
