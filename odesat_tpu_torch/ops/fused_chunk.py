"""The resident multi-step ODE chunk: a hand-written CUDA kernel for Hopper
and its plain torch version.

Replaces the TPU kernel ``odesat_tpu/ops/fused_pallas.py::make_fused_chunk``
(Pallas; kernel body :164-332). Like it, one launch advances every
trajectory ``chunk_steps`` Euler steps with the state held on chip, so the
state crosses device memory once per chunk instead of once per step.

Design for the card (``csrc/fused_chunk.cu``): one CTA per trajectory.
The formula's index tables (a literal code per ``(k, m)`` slot and a CSR
list of each variable's slots) and the trajectory's ``v``, ``xs``, ``xl``
live in shared memory for the whole chunk; ``dt`` and ``done`` live in
registers. Each step is a clause phase (threads over clauses: gather
``v``, running top-2 min, coefficients, per-slot contributions into a
shared buffer) and a variable phase (threads over variables: a fixed-order
sum over the variable's CSR slots). The TPU kernel's sign-baked one-hot
planes and its two matmuls per RHS pass exist because the TPU gathers
poorly; Hopper gathers from shared memory at full speed, so the port
gathers and never touches an ``(Np, K*Mp)`` plane.

What bounds it on the card: shared-memory gathers and the two (fixed) or
five (adaptive) block barriers per step, not device memory: a chunk of
256 steps reads and writes each state row once. What the design does
about it: no float atomics (the dv sum runs in a fixed order, so repeats
are bit-identical), the state stays resident, and a ragged batch needs no
padding rows because the grid is exactly one CTA per trajectory. Its
support gate is its shared-memory footprint (:func:`fused_smem_bytes`,
at most 227 KB a CTA), in place of the TPU's 8 MiB VMEM envelope.

:func:`fused_chunk_plain` is the same arithmetic in torch tensor ops,
with the same rounding points (bf16 rounding of ``v`` before the literal
values and of each contribution before the f32 dv sum) and the same
fixed-order dv sum. The CPU tests run it; ``chip_smoke.py`` holds the
kernel against it on the card. :func:`make_fused_chunk` launches the
kernel for CUDA tensors and runs the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays
from odesat_tpu_torch.constants import (
    ALPHA,
    BETA,
    DELTA,
    DT_MAX,
    DT_MIN,
    EPSILON,
    GAMMA,
    XL_CAP_PER_CLAUSE,
)
from odesat_tpu_torch.ops import _cuda

SMEM_LIMIT_BYTES = 232448  # 227 KB: the most dynamic shared memory an H100 CTA may use
_INF = float("inf")

# Kernel launches made through fused_chunk_cuda in this process. A plain
# integer that callers may reset; chip_smoke.py reads it to show that the
# main path went through the kernel.
launches = 0


@dataclass(frozen=True)
class ChunkTables:
    """The formula as the chunk kernel reads it (NumPy, device-neutral).

    ``lit_code``: (K*Mp,) int32, ``2*var + negated`` per ``(k, m)`` slot,
    -1 at padding. ``occ_ptr``/``occ_slot``: CSR lists, per variable, of
    the flat slots ``k*Mp + m`` holding it, in (clause, slot) order."""

    lit_code: np.ndarray
    occ_ptr: np.ndarray
    occ_slot: np.ndarray
    K: int
    Mp: int
    Np: int


def chunk_tables(fa: FormulaArrays) -> ChunkTables:
    """Build the kernel's tables from ``lit_var``/``sign``/``lit_mask``.
    They index the (K, Mp) slot grid directly, so they are valid for
    width-bucketed layouts too (whose ``var_occ`` indexes another flat
    layout)."""
    K, Mp = fa.lit_var.shape
    Np = fa.n_vars_padded
    on = fa.lit_mask > 0
    code = np.where(on, 2 * fa.lit_var + (fa.sign < 0), -1).astype(np.int32)
    ks, ms = np.nonzero(on)
    var = fa.lit_var[ks, ms]
    order = np.lexsort((ks, ms, var))  # by variable, then clause, then slot
    slots = (ks * Mp + ms)[order].astype(np.int32)
    counts = np.bincount(var, minlength=Np).astype(np.int32)
    ptr = np.zeros(Np + 1, dtype=np.int32)
    np.cumsum(counts, out=ptr[1:])
    return ChunkTables(code.reshape(-1), ptr, slots, K, Mp, Np)


def fused_smem_bytes(fa: FormulaArrays, fixed: bool) -> int:
    """Shared memory one CTA needs, word for word the carve-up of
    ``csrc/fused_chunk.cu`` (its ``fused_chunk_smem_bytes`` computes the
    same number): literal codes, CSR lists, v/xs/xl, the contribution
    buffer, 32 words of reduction scratch, and in adaptive mode the half-
    and full-step trial states."""
    K, Mp = fa.lit_var.shape
    Np = fa.n_vars_padded
    nnz = int((fa.lit_mask > 0).sum())
    words = K * Mp + (Np + 1) + nnz + Np + 2 * Mp + K * Mp + 32
    if not fixed:
        words += 2 * (Np + 2 * Mp)
    return 4 * words


def fused_supported(fa: FormulaArrays, fixed: bool = False) -> bool:
    """The kernel's gate: no unit clauses (their infinite gradients are
    the scan path's business, ops/rhs.py) and a shared-memory footprint
    one CTA can hold. ``fixed=False`` checks the larger adaptive footprint."""
    return fa.min_width >= 2 and fused_smem_bytes(fa, fixed) <= SMEM_LIMIT_BYTES


@dataclass(frozen=True)
class ChunkSpec:
    """One formula and integrator, ready on one device."""

    device: torch.device
    lit_code: torch.Tensor  # (K*Mp,) int32
    occ_ptr: torch.Tensor  # (Np+1,) int32
    occ_slot: torch.Tensor  # (nnz,) int32
    clause_on: torch.Tensor  # (Mp,) bool
    K: int
    Mp: int
    Np: int
    zeta: float
    dt_fixed: Optional[float]  # None: adaptive
    tol: float
    xl_cap: float
    paper: bool
    bf16: bool

    @property
    def fixed(self) -> bool:
        return self.dt_fixed is not None


def check_chunk_config(ode, kernel: str) -> None:
    """Raise ValueError for what no chunk kernel takes: float64 and a
    batch-shared adaptive dt. ``kernel`` names the kernel in the message."""
    if ode.dtype == "float64":
        # the kernel carries f32 state; silently downcasting a requested
        # f64 run would betray the reference-parity dtype
        raise ValueError(
            f"dtype='float64' is not supported by the {kernel}; "
            "use dv_strategy='gather'/'segment_sum' (the scan path) for f64"
        )
    if ode.dt_mode == "shared" and ode.step_size is None:
        raise ValueError(
            f"dt_mode='shared' is not supported by the {kernel} (it "
            "carries one dt per trajectory); use dv_strategy='auto' or "
            "per-trajectory dt"
        )


def cuda_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a bare ``cuda`` becomes the current
    ``cuda:N``, which is what tensors report, so checks compare like with
    like."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def spec_fields(fa: FormulaArrays, zeta: float, ode, device: torch.device,
                t: ChunkTables) -> dict:
    """The fields of a :class:`ChunkSpec` for ``fa`` with tables ``t`` on
    ``device`` (no gate is checked here)."""

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    fixed = ode.step_size is not None
    return dict(
        device=device,
        lit_code=put(t.lit_code, torch.int32),
        occ_ptr=put(t.occ_ptr, torch.int32),
        occ_slot=put(t.occ_slot, torch.int32),
        clause_on=put(fa.clause_mask > 0, torch.bool),
        K=t.K,
        Mp=t.Mp,
        Np=t.Np,
        zeta=float(zeta),
        dt_fixed=float(ode.step_size) if fixed else None,
        tol=float(ode.tolerance),
        xl_cap=XL_CAP_PER_CLAUSE * fa.n_clauses,
        paper=ode.rigidity == "paper",
        bf16=ode.matmul_dtype == "bfloat16",
    )


def chunk_spec(fa: FormulaArrays, zeta: float, ode, device) -> ChunkSpec:
    """Check ``ode`` against what the kernel takes and move the tables to
    ``device``. Raises ValueError for float64, a batch-shared adaptive dt
    and formulas outside the gate."""
    check_chunk_config(ode, "fused chunk kernel")
    fixed = ode.step_size is not None
    if not fused_supported(fa, fixed):
        raise ValueError(
            "fused chunk kernel unsupported for this formula (unit clauses, or "
            f"{fused_smem_bytes(fa, fixed)} bytes of shared memory per CTA "
            f"exceed {SMEM_LIMIT_BYTES}); use the scan path"
        )
    return ChunkSpec(**spec_fields(fa, zeta, ode, cuda_device(device), chunk_tables(fa)))


# ---------------------------------------------------------------- plain


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _clamp(x, lo, hi):
    # fmax/fmin ignore NaN like the kernel's fmaxf/fminf
    return torch.fmin(torch.fmax(x, x.new_tensor(lo)), x.new_tensor(hi))


class PlainTables(NamedTuple):
    lit_var: torch.Tensor  # (K, Mp) int64, 0 at padding
    negated: torch.Tensor  # (K, Mp) bool
    lit_on: torch.Tensor  # (K, Mp) bool
    occ_pad: torch.Tensor  # (Np, D) int64, padded with K*Mp (a slot that is always 0)


def plain_tables(spec: ChunkSpec) -> PlainTables:
    """Decode the kernel's tables for the plain version: the literal codes
    into variable, sign and mask, the CSR lists into an (Np, D) table."""
    code = spec.lit_code.long().view(spec.K, spec.Mp)
    on = code >= 0
    ptr = spec.occ_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    D = max(int(counts.max()), 1)
    var = torch.repeat_interleave(torch.arange(spec.Np, device=ptr.device), counts)
    rank = torch.arange(var.numel(), device=ptr.device) - ptr[var]
    pad = torch.full((spec.Np, D), spec.K * spec.Mp, dtype=torch.long, device=ptr.device)
    pad[var, rank] = spec.occ_slot.long()
    return PlainTables(torch.where(on, code >> 1, 0), on & (code & 1).bool(), on, pad)


_DECODED: dict = {}  # id(spec) -> (spec, its decoded tables), bounded


def cached_tables(spec, decode):
    """``decode(spec)``, kept while ``spec`` lives: the per-step plain
    versions of the clause-shard kernels (B5, B8) would otherwise decode
    the shard's tables every step."""
    hit = _DECODED.get(id(spec))
    if hit is None or hit[0] is not spec:
        if len(_DECODED) >= 16:
            _DECODED.clear()
        hit = _DECODED[id(spec)] = (spec, decode(spec))
    return hit[1]


def _rhs_plain(v, xs, xl, spec: ChunkSpec, t: PlainTables):
    """One RHS pass; returns (dv, dxs, dxl, allsat) exactly as the
    kernel's clause and variable phases compute them."""
    B = v.shape[0]
    vv = _bf16(v) if spec.bf16 else v
    g = vv[:, t.lit_var]  # (B, K, Mp)
    vals = torch.where(t.lit_on, 1.0 - torch.where(t.negated, -g, g), _INF)
    m1 = vals[:, 0]
    m2 = torch.full_like(m1, _INF)
    for k in range(1, spec.K):
        m2 = torch.minimum(m2, torch.maximum(m1, vals[:, k]))
        m1 = torch.minimum(m1, vals[:, k])
    c = 0.5 * m1
    a = -0.5 * (xl * xs)
    b = (-0.5 * ((1.0 + spec.zeta * xl) * (1.0 - xs))).unsqueeze(1)
    A1 = (a * m1).unsqueeze(1)
    A2 = (a * m2).unsqueeze(1)
    is_min = vals <= m1.unsqueeze(1)
    if spec.paper:
        cp = torch.where(is_min, A2 + b * vals, A1)
    else:
        gate = (vals == c.unsqueeze(1)).to(vals.dtype)
        cp = torch.where(is_min, A2, A1) + b * (vals * gate)
    if spec.bf16:
        cp = _bf16(cp)
    # times -q (the TPU kernel's sign-baked plane factor); padding is 0
    contrib = torch.where(t.lit_on, torch.where(t.negated, cp, -cp), 0.0)
    flat = torch.cat([contrib.reshape(B, -1), contrib.new_zeros(B, 1)], dim=1)
    picked = flat[:, t.occ_pad]  # (B, Np, D)
    dv = torch.zeros_like(v)
    for d in range(picked.shape[-1]):  # fixed order, as the kernel sums
        dv = dv + picked[:, :, d]
    on = spec.clause_on
    dxs = torch.where(on, BETA * (xs + EPSILON) * (c - GAMMA), 0.0)
    dxl = torch.where(on, ALPHA * (c - DELTA), 0.0)
    allsat = ((c < GAMMA) | ~on).all(dim=1)
    return dv, dxs, dxl, allsat


def _update(v, xs, xl, dv, dxs, dxl, dt_col, xl_cap):
    xs2 = _clamp(xs + dt_col * dxs, EPSILON, 1.0 - EPSILON)
    xl2 = _clamp(xl + dt_col * dxl, 1.0, xl_cap)
    v2 = _clamp(v + dt_col * dv, -1.0, 1.0)
    return v2, xs2, xl2


def fused_chunk_plain(state, spec: ChunkSpec, chunk_steps: int):
    """``chunk_steps`` steps of the kernel's arithmetic in torch ops, on
    any device. Fixed mode updates on the step that detects allsat, then
    freezes; adaptive mode never advances a done or satisfied row."""
    v, xs, xl = state.v, state.xs, state.xl
    dt, done = state.dt, state.done
    t = plain_tables(spec)
    for _ in range(chunk_steps):
        dv, dxs, dxl, allsat = _rhs_plain(v, xs, xl, spec, t)
        if spec.fixed:
            dt_col = torch.where(done, 0.0, spec.dt_fixed).to(v.dtype).unsqueeze(1)
            v, xs, xl = _update(v, xs, xl, dv, dxs, dxl, dt_col, spec.xl_cap)
        else:
            advance = ~done & ~allsat
            dt_col = torch.where(advance, dt, 0.0).unsqueeze(1)
            half = 0.5 * dt_col
            fv, fxs, fxl = _update(v, xs, xl, dv, dxs, dxl, dt_col, spec.xl_cap)
            hv, hxs, hxl = _update(v, xs, xl, dv, dxs, dxl, half, spec.xl_cap)
            dv2, dxs2, dxl2, _ = _rhs_plain(hv, hxs, hxl, spec, t)
            tv, txs, txl = _update(hv, hxs, hxl, dv2, dxs2, dxl2, half, spec.xl_cap)
            err = torch.maximum(
                (fv - tv).abs().amax(dim=1),
                torch.maximum((fxs - txs).abs().amax(dim=1), (fxl - txl).abs().amax(dim=1)),
            )
            # a tensor numerator: `float / tensor` is reciprocal-then-multiply
            # in torch, which rounds twice where the kernel divides once
            ratio = err.new_tensor(spec.tol) / err.clamp_min(1e-30)
            new_dt = _clamp(dt * torch.sqrt(ratio), DT_MIN, DT_MAX)
            adv = advance.unsqueeze(1)
            v = torch.where(adv, tv, v)
            xs = torch.where(adv, txs, xs)
            xl = torch.where(adv, txl, xl)
            dt = torch.where(advance, new_dt, dt)
        done = done | allsat
    return state._replace(v=v, xs=xs, xl=xl, dt=dt, done=done)


# ---------------------------------------------------------------- kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _declare(lib) -> None:
    lib.fused_chunk_launch.argtypes = [_P] * 13 + [_I] * 10 + [_F] * 4 + [_P]
    lib.fused_chunk_launch.restype = _I
    lib.fused_chunk_smem_bytes.argtypes = [_I] * 5
    lib.fused_chunk_smem_bytes.restype = ctypes.c_size_t
    lib.fused_chunk_error_string.argtypes = [_I]
    lib.fused_chunk_error_string.restype = ctypes.c_char_p


def load_library():
    """Build (at first use) and load the kernel. Returns ``(lib, build)``."""
    return _cuda.load("fused_chunk", _declare)


def kernel_threads(Mp: int) -> int:
    """Threads per CTA: about two clauses a thread, a whole number of
    warps (the block reduction needs full warps), 64 to 256."""
    return min(256, max(64, 32 * -(-Mp // 64)))


def check_state(state, spec: ChunkSpec) -> None:
    """Raise ValueError unless the state is what the chunk kernels take:
    on the formula's device, float32 (done bool), the formula's shapes,
    contiguous."""
    B = state.v.shape[0]
    want = {
        "v": ((B, spec.Np), torch.float32),
        "xs": ((B, spec.Mp), torch.float32),
        "xl": ((B, spec.Mp), torch.float32),
        "dt": ((B,), torch.float32),
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


def fused_chunk_cuda(state, spec: ChunkSpec, chunk_steps: int):
    """Launch the kernel once on the current stream of the state's device.
    Raises if the state is not what the kernel takes or if the launch is
    refused; never falls back."""
    global launches
    if spec.device.type != "cuda":
        raise ValueError(f"the fused chunk kernel runs on CUDA tensors, not {spec.device}")
    check_state(state, spec)
    B = state.v.shape[0]
    if B == 0:
        return state
    lib, _ = load_library()
    out = [torch.empty_like(t) for t in state]
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.fused_chunk_launch(
            *(t.data_ptr() for t in state),
            *(t.data_ptr() for t in out),
            spec.lit_code.data_ptr(), spec.occ_ptr.data_ptr(), spec.occ_slot.data_ptr(),
            B, spec.Np, spec.Mp, spec.K, spec.occ_slot.numel(), int(chunk_steps),
            int(spec.fixed), int(spec.paper), int(spec.bf16),
            kernel_threads(spec.Mp),
            spec.zeta, spec.dt_fixed or 0.0, spec.tol, spec.xl_cap,
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            "fused chunk kernel launch failed: "
            + lib.fused_chunk_error_string(rc).decode()
        )
    launches += 1
    return type(state)(*out)


def make_fused_chunk(fa: FormulaArrays, zeta: float, ode, chunk_steps: int, device):
    """Build ``fn(state, dev=None) -> state`` advancing every trajectory
    ``chunk_steps`` steps in one kernel launch. CUDA states go through the
    kernel; CPU states (the tests) through :func:`fused_chunk_plain`;
    anything else raises. ``dev`` is accepted for signature parity with
    the scan runner and ignored: the formula is in ``fn.spec``."""
    spec = chunk_spec(fa, zeta, ode, device)

    def fn(state, dev=None):
        kind = state.v.device.type
        if kind == "cuda":
            return fused_chunk_cuda(state, spec, chunk_steps)
        if kind == "cpu":
            return fused_chunk_plain(state, spec, chunk_steps)
        raise ValueError(f"no fused chunk path for tensors on {state.v.device}")

    fn.spec = spec
    return fn
