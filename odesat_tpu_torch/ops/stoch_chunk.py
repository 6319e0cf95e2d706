"""The stochastic engine's kernels for Hopper: the chunk kernels B3 and B4
and the one plain torch version of what both compute, and below them the
clause mesh's B8 (one shard's evaluation) and B9 (the clause-sharded
chunk's launches), each with its plain version.

B3 replaces ``odesat_tpu/ops/stoch_pallas.py::make_fused_stoch_chunk``
(Pallas; kernel body :134-211), B4 replaces ``make_stream_stoch_chunk``
(kernel :394-503). Like them, one launch advances every chain
``chunk_steps`` steps of clause-weighted local search with the chain's
state held on chip (reference semantics: src/stoch.rs:26-78).

Design for the card (``csrc/stoch_chunk.cu``): one CTA per chain; the
chain's ``v`` (bytes) and ``xl`` (int32) live in shared memory for the
whole chunk. B3 also copies the formula's index tables there (a literal
code per ``(k, m)`` slot and a CSR list of each variable's clauses, built
by ``ops/fused_chunk.chunk_tables``); B4 reads them from global memory,
where they stay in L2, so its gate is the chain's state alone. The TPU
kernels' polarity-baked one-hot planes and their matmuls exist because the
TPU gathers poorly; here every step is a clause phase (sat, weight update)
and a variable phase (weight sums over the CSR list in a fixed order, the
counter-hash uniform, the flip), with no float atomics.

What bounds them: shared-memory gathers and two block barriers per step,
plus, for B4, L2 reads of the tables; not device memory. Gates:
:func:`stoch_fused_smem_bytes` and :func:`stoch_stream_smem_bytes`, each at
most 227 KB a CTA, in place of the TPU's 8 MiB VMEM and plane budgets.
Unlike the ODE kernel, both take unit clauses.

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
from typing import NamedTuple

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays
from odesat_tpu_torch.constants import STOCH_ALPHA
from odesat_tpu_torch.ops import _cuda
from odesat_tpu_torch.ops.fused_chunk import (
    SMEM_LIMIT_BYTES,
    cached_tables,
    chunk_tables,
    cuda_device,
    kernel_threads,
)

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


def stoch_fused_smem_bytes(fa: FormulaArrays) -> int:
    """B3's shared memory per CTA, the carve-up of ``csrc/stoch_chunk.cu``
    (its ``stoch_fused_smem_bytes`` computes the same): literal codes, CSR
    pointers and clause lists, the chain's xl (int32) and v (bytes)."""
    K, Mp = fa.lit_var.shape
    nnz = int((fa.lit_mask > 0).sum())
    return 4 * (K * Mp + (fa.n_vars_padded + 1) + nnz + Mp) + fa.n_vars_padded


def stoch_stream_smem_bytes(fa: FormulaArrays) -> int:
    """B4's shared memory per CTA (``stoch_stream_smem_bytes``): the
    chain's xl and v; the tables stay in global memory."""
    return 4 * fa.n_clauses_padded + fa.n_vars_padded


def stoch_fused_supported(fa: FormulaArrays) -> bool:
    """B3's gate: formula tables and chain state fit one CTA."""
    return stoch_fused_smem_bytes(fa) <= SMEM_LIMIT_BYTES


def stoch_stream_supported(fa: FormulaArrays) -> bool:
    """B4's gate: the chain state fits one CTA (up to ~58k padded clauses
    at Np=128)."""
    return stoch_stream_smem_bytes(fa) <= SMEM_LIMIT_BYTES


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


def stoch_spec(fa: FormulaArrays, device) -> StochSpec:
    """Build the kernels' tables from the formula and move them to
    ``device``. The occurrence lists are ``chunk_tables``' (variable, then
    clause, then slot order) mapped from slots to clause columns."""
    device = cuda_device(device)
    t = chunk_tables(fa)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return StochSpec(
        device=device,
        lit_code=put(t.lit_code),
        occ_ptr=put(t.occ_ptr),
        occ_clause=put(t.occ_slot % t.Mp),
        K=t.K,
        Mp=t.Mp,
        Np=t.Np,
    )


# ---------------------------------------------------------------- plain


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): split into 16-bit
    halves, so no int64 product overflows."""
    lo = x & 0xFFFF
    hi = x >> 16
    return ((((hi * c) & _MASK) << 16) + lo * c) & _MASK


def uniform01(seed: int, chains: torch.Tensor, Bb: int, step: int, Np: int) -> torch.Tensor:
    """The counter-hash uniforms (B, Np) f32 in [0, 1) of ``_make_uniform01``
    for chains ``chains`` (int64 global indices) at launch-local ``step``."""
    blk = chains // Bb
    r = chains % Bb
    c = torch.arange(Np, device=chains.device, dtype=torch.int64)
    block_seed = (int(seed) + _mul32(blk, 0x632BE59B)) & _MASK
    base = (block_seed + _mul32(torch.full_like(blk, int(step)), 0xC2B2AE3D)) & _MASK
    x = _mul32(r, 0x9E3779B1).unsqueeze(1) ^ _mul32(c, 0x85EBCA77).unsqueeze(0)
    x = x ^ base.unsqueeze(1)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


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
        fn.argtypes = [_P] * 9 + [_I] * 6 + [ctypes.c_uint] + [_I] * 3 + [_P]
        fn.restype = _I
    lib.stoch_fused_smem_bytes.argtypes = [_I] * 4
    lib.stoch_fused_smem_bytes.restype = ctypes.c_size_t
    lib.stoch_stream_smem_bytes.argtypes = [_I] * 2
    lib.stoch_stream_smem_bytes.restype = ctypes.c_size_t
    lib.stoch_shard_eval_launch.argtypes = [_P] * 11 + [_I] * 8 + [_P]
    lib.stoch_shard_eval_launch.restype = _I
    lib.stoch_shard_step_launch.argtypes = (
        [_P] * 8 + [_I] * 8 + [ctypes.c_uint] + [_I] * 4 + [_P]
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


def _launch(entry: str, state, spec: StochSpec, chunk_steps: int, seed: int, bf16: bool):
    if spec.device.type != "cuda":
        raise ValueError(f"the stoch chunk kernels run on CUDA tensors, not {spec.device}")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} is not a uint32")
    _check(state, spec)
    B = state.v.shape[0]
    lib, _ = load_library()
    out = type(state)(*(torch.empty_like(t) for t in state))
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in state),
            *(t.data_ptr() for t in out),
            spec.lit_code.data_ptr(), spec.occ_ptr.data_ptr(), spec.occ_clause.data_ptr(),
            B, spec.Np, spec.Mp, spec.K, spec.occ_clause.numel(), int(chunk_steps),
            int(seed), traj_block(B), int(bf16), kernel_threads(spec.Mp),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{entry} failed: " + lib.stoch_chunk_error_string(rc).decode()
        )
    return out


def stoch_fused_cuda(state, spec: StochSpec, chunk_steps: int, seed: int, bf16: bool):
    """Launch B3 once on the current stream. Raises if the state is not
    what it takes or the launch is refused (a formula past its gate is:
    the shared-memory request fails)."""
    global fused_launches
    if state.v.shape[0] == 0:
        return state
    out = _launch("stoch_fused_launch", state, spec, chunk_steps, seed, bf16)
    fused_launches += 1
    return out


def stoch_stream_cuda(state, spec: StochSpec, chunk_steps: int, seed: int, bf16: bool):
    """Launch B4 once on the current stream. Raises if the state is not
    what it takes or the launch is refused (a chain state past its gate
    is)."""
    global stream_launches
    if state.v.shape[0] == 0:
        return state
    out = _launch("stoch_stream_launch", state, spec, chunk_steps, seed, bf16)
    stream_launches += 1
    return out


# ------------------------------------------ one clause shard's evaluation (B8)
#
# B8 replaces ``odesat_tpu/ops/stoch_pallas.py::make_stoch_shard_eval``
# (Pallas; call :814): on a clause mesh each rank evaluates one step over
# its own clause segment; the caller all-reduces the (total, unsat) partial
# sums and the sat flag over the clause group and draws the flips in torch
# (parallel/sharded.py). The TPU kernel reused the ODE shard plan's
# sign-baked planes for matmul gathers and scatters; here one CTA per chain
# runs B4's clause and variable phases over the shard's tables (the shard
# plan's literal codes and local CSR, ops/shard_stream.py), with the chain's
# v and the shard's xl in shared memory while they fit. What bounds it on
# the card: device-memory bytes, since xl (B, Mp_local) is read and written
# and two (B, Np) partials are written every step; the tables stay in L2.

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


def stoch_shard_smem_bytes(spec: StochSpec) -> tuple:
    """``(bytes, xl resident)``: B8 keeps the shard's xl (int32) in shared
    memory when it fits beside v (bytes), else in a scratch row a chain."""
    full = 4 * spec.Mp + spec.Np
    return (full, True) if full <= SMEM_LIMIT_BYTES else (spec.Np, False)


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


def stoch_shard_eval_cuda(v, xl, active, spec: StochSpec, bf16: bool):
    """Launch B8 once on the current stream; returns what the plain version
    returns. Raises if an input is not what it takes or the launch is
    refused; never falls back."""
    global shard_launches
    if spec.device.type != "cuda":
        raise ValueError(f"the stoch shard kernel runs on CUDA tensors, not {spec.device}")
    _check(SimpleNamespace(v=v, xl=xl, done=active), spec)  # active checks as done does
    B = v.shape[0]
    tot = torch.empty((B, spec.Np), dtype=torch.float32, device=spec.device)
    uns = torch.empty_like(tot)
    xl_out = torch.empty_like(xl)
    sat = torch.empty(B, dtype=torch.bool, device=spec.device)
    if B == 0:
        return tot, uns, xl_out, sat
    smem, resident = stoch_shard_smem_bytes(spec)
    scratch = torch.empty(1 if resident else B * spec.Mp, dtype=torch.int32, device=spec.device)
    lib, _ = load_library()
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.stoch_shard_eval_launch(
            v.data_ptr(), active.data_ptr(), xl.data_ptr(), tot.data_ptr(), uns.data_ptr(),
            xl_out.data_ptr(), sat.data_ptr(), spec.lit_code.data_ptr(), spec.occ_ptr.data_ptr(),
            spec.occ_clause.data_ptr(), scratch.data_ptr(), B, spec.Np, spec.Mp, spec.K,
            spec.occ_clause.numel(), int(resident), int(bf16), kernel_threads(spec.Mp), stream,
        )
    if rc != 0:
        raise RuntimeError("stoch_shard_eval_launch failed: "
                           + lib.stoch_chunk_error_string(rc).decode())
    shard_launches += 1
    return tot, uns, xl_out, sat


def make_stoch_shard_eval(fa: FormulaArrays, device, shard: int = 0,
                          matmul_dtype: str = "float32"):
    """``eval(v, xl, active) -> (total, unsat, xl_new, sat)`` over shard
    ``shard`` of ``fa.shard_plan`` (JAX :605): B8 for CUDA tensors, its
    plain version for CPU tensors; anything else raises. v (B, Np) bool,
    xl (B, Mp_local) int32, active (B,) bool."""
    if fa.shard_plan is None:
        raise ValueError("needs a compile_stream_sharded formula (shard plan)")
    spec = stoch_shard_spec(fa, device, shard)
    bf16 = matmul_dtype == "bfloat16"

    def ev(v, xl, active):
        kind = v.device.type
        if kind == "cuda":
            return stoch_shard_eval_cuda(v, xl, active, spec, bf16)
        if kind == "cpu":
            return stoch_shard_eval_plain(v, xl, active, spec, bf16)
        raise ValueError(f"no stoch shard path for tensors on {v.device}")

    ev.spec = spec
    return ev


# ------------------------------------ the clause-sharded stoch chunk (B9)
#
# B9 replaces ``odesat_tpu/ops/stoch_pallas.py::make_stoch_shard_chunk``
# (Pallas; call :1161), the whole-chunk clause-shard kernel that all-reduced
# the (total, unsat, sat) partials inside itself over ICI remote DMA (B7,
# ``odesat_tpu/ops/butterfly.py``). On Hopper that collective runs between
# launches (``torch.distributed.all_reduce``), so the chunk is a launch per
# step of ``stoch_shard_step_launch`` (``csrc/stoch_chunk.cu``) and one more:
# each launch applies the previous step's reduced sums (the flip with the
# counter-hash uniforms of that step, the done latch) and evaluates the
# shard for its own step as B8 does, into ``acc`` = (total | unsat | 1 -
# sat). The flips and their uniforms, which B8's path drew in torch, run in
# the kernel. Same seed, blocking and step index as B8's path, so the two
# flip for flip; the sums are integers in f32, so S=2 flips as S=1 does.

shard_chunk_launches = 0  # B9 launches, as shard_launches counts B8's


def stoch_shard_supported(fa: FormulaArrays) -> bool:
    """B8's and B9's gate: a shard plan and a chain's v (bytes) in one CTA;
    the shard's xl lives in shared memory or in a scratch row. Unit clauses
    are fine."""
    return fa.shard_plan is not None and fa.n_vars_padded <= SMEM_LIMIT_BYTES


def stoch_shard_step_plain(v, xl, done, acc, spec: StochSpec, bf16: bool, seed: int, Bb: int,
                           t: int, apply: bool, evaluate: bool = True):
    """One launch of B9 in torch ops: returns ``(v, xl, done, acc)`` as the
    kernel leaves them. ``acc`` (B, 2*Np+1) holds the reduced sums of step
    ``t - 1`` on entry (read when ``apply``) and the shard's partials of
    step ``t`` on exit (when ``evaluate``)."""
    Np = spec.Np
    if apply:
        chains = torch.arange(v.shape[0], device=v.device, dtype=torch.int64)
        u = uniform01(seed, chains, Bb, t - 1, Np)
        flip = u * acc[:, :Np] < acc[:, Np:2 * Np]
        v = torch.where((~done).unsqueeze(1) & flip, ~v, v)
        done = done | (acc[:, 2 * Np] == 0)
    if not evaluate:
        return v, xl, done, acc
    total, unsat, xl, sat = stoch_shard_eval_plain(v, xl, ~done, spec, bf16)
    return v, xl, done, torch.cat([total, unsat, (~sat).to(total.dtype).unsqueeze(1)], dim=1)


def stoch_shard_step_cuda(v, xl, done, acc, spec: StochSpec, bf16: bool, seed: int, Bb: int,
                          t: int, apply: bool, evaluate: bool = True):
    """Launch B9 once on the current stream; v, xl, done and acc are
    updated in place and returned. Raises if an input is not what it takes
    or the launch is refused; never falls back."""
    global shard_chunk_launches
    if spec.device.type != "cuda":
        raise ValueError(f"the stoch shard chunk kernel runs on CUDA tensors, not {spec.device}")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} is not a uint32")
    _check(SimpleNamespace(v=v, xl=xl, done=done), spec)
    B = v.shape[0]
    if acc.device != spec.device or tuple(acc.shape) != (B, 2 * spec.Np + 1) or \
            acc.dtype != torch.float32 or not acc.is_contiguous():
        raise ValueError(f"acc is {tuple(acc.shape)} {acc.dtype}; the kernel takes a contiguous "
                         f"({B}, {2 * spec.Np + 1}) float32 on {spec.device}")
    if B == 0:
        return v, xl, done, acc
    _, resident = stoch_shard_smem_bytes(spec)
    scratch = torch.empty(1 if resident else B * spec.Mp, dtype=torch.int32, device=spec.device)
    lib, _ = load_library()
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.stoch_shard_step_launch(
            v.data_ptr(), xl.data_ptr(), done.data_ptr(), acc.data_ptr(),
            spec.lit_code.data_ptr(), spec.occ_ptr.data_ptr(), spec.occ_clause.data_ptr(),
            scratch.data_ptr(), B, spec.Np, spec.Mp, spec.K, spec.occ_clause.numel(),
            int(resident), int(bf16), kernel_threads(spec.Mp), int(seed), int(Bb), int(t),
            int(apply), int(evaluate), stream,
        )
    if rc != 0:
        raise RuntimeError("stoch_shard_step_launch failed: "
                           + lib.stoch_chunk_error_string(rc).decode())
    shard_chunk_launches += 1
    return v, xl, done, acc


def make_stoch_shard_chunk(fa: FormulaArrays, chunk_steps: int, device, shard: int = 0,
                           clause_group=None, matmul_dtype: str = "float32"):
    """``fn(state, seed) -> state`` advancing this rank's chains
    ``chunk_steps`` steps over shard ``shard`` of ``fa.shard_plan`` (JAX
    :868): B9's launches (CUDA states) or its plain version (CPU states),
    with the sums all-reduced over ``clause_group`` between them (none
    without a group). ``seed`` is the chunk's 31-bit PRNG seed, the same
    on every clause rank of a row. The caller's state is never written."""
    from odesat_tpu_torch.parallel.dist import all_reduce

    if not stoch_shard_supported(fa):
        raise ValueError("the clause-shard stoch kernels need a compile_stream_sharded "
                         "formula whose v fits one CTA")
    spec = stoch_shard_spec(fa, device, shard)
    bf16 = matmul_dtype == "bfloat16"

    def fn(state, seed: int):
        kind = state.v.device.type
        if kind == "cuda":
            launch = stoch_shard_step_cuda
        elif kind == "cpu":
            launch = stoch_shard_step_plain
        else:
            raise ValueError(f"no stoch shard chunk path for tensors on {state.v.device}")
        B = state.v.shape[0]
        Bb = traj_block(B)
        v, xl, done = state.v.clone(), state.xl.clone(), state.done.clone()
        acc = torch.empty((B, 2 * spec.Np + 1), dtype=torch.float32, device=state.v.device)
        for t in range(chunk_steps + 1):
            v, xl, done, acc = launch(v, xl, done, acc, spec, bf16, seed, Bb, t, apply=t > 0,
                                      evaluate=t < chunk_steps)
            if t < chunk_steps and clause_group is not None:
                all_reduce(acc, clause_group)
        return state._replace(v=v, xl=xl, done=done)

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
