"""One clause shard's ODE right-hand side (kernel B5): the clause-sharded
compile, a hand-written CUDA kernel for Hopper, its plain torch version and
the clause-mesh step built on it (the ``--shard-chunk off`` path).

Replaces the TPU kernel ``odesat_tpu/ops/shard_stream.py::_make_shard_call``
(Pallas; call :685, kernel body ``_build_kernel`` :361). On a clause mesh
every rank holds the state rows of its trajectory block and one contiguous
segment of the clause axis; a launch evaluates the RHS over that segment
only and returns the shard's *partial* dv, which the caller all-reduces
over the clause group (``torch.distributed``, outside the kernel, where the
TPU summed with ``psum`` over ICI). Three modes, as on the TPU:

* ``rhs``: dv partial, dxs, dxl of the shard's clauses and the shard's
  all-satisfied flag (the adaptive integrator's first evaluation);
* ``fixed``: dv partial and the flag, with the clamped Euler update of the
  shard's xs and xl (dt is 0 for done rows);
* ``second``: the adaptive second evaluation at the half step ``hv``: the
  half-step clause state is recomputed from the first launch's dxs/dxl,
  the final xs/xl come out under the advance flag, and so does the shard's
  part of the step-doubling error.

The v update, dt control and done latch run in torch after the all-reduce
(:func:`make_fused_clause_step`, the port of the TPU module's :744-854).

Design for the card (``shard_stream_launch`` in ``csrc/stream_chunk.cu``):
a launch is the pass of the clause-sharded chunk B6 (``ops/shard_chunk.py``)
over the same tile layout (``ops/tiles.py``: ``(B, X)`` becomes
``(ceil(B/32), X, 32)``), with the step and the advance flag given instead
of derived, and without B6's apply prologue. A tile's 32 trajectories sit
on the lanes of a thread group, so each table word (a literal code per
``(k, m_local)`` slot and, per variable, a CSR list of its occurrences in
the shard's clauses, ``2*m_local + negated``, in the global CSR order
restricted to the shard) serves 32 trajectories and each gather moves a
128-byte line; the clause words m1, m2 are recomputed per occurrence
instead of stored, the clause side of the pass runs at each clause's first
occurrence, and nothing of a trajectory lives in shared memory. The TPU
kernel's sign-baked one-hot planes and matmuls have no counterpart. The
new clause memories go to a second copy (``ShardScratch``), which the
runner swaps with xs and xl; dv and the negated sat flag come out packed,
``(G, Np+1, 32)``, the buffer the clause group all-reduces as it is.

The runner (:func:`make_clause_chunk` over :func:`make_fused_clause_step`)
tiles the state in its own storage once at chunk entry and untiles it once
at exit; between, every launch, all-reduce and torch update of a step
works on tiled tensors and writes into buffers held for the batch shape. The row-major
functions (:func:`shard_rhs`, :func:`shard_fixed`, :func:`shard_second`,
:func:`make_stream_shard_rhs`) keep the JAX package's ``(B, X)`` contract:
on CUDA they tile, launch and untile.

What bounds it: device-memory bytes. The state crosses device memory every
step: ``fixed`` reads v, xs and xl and writes the partials and the new xs
and xl, about 0.8 GB a step at the config-7 instance (Np=10240, Mp=43,776)
and B=1024, 0.24 ms at 3.35 TB/s, plus the occurrence gathers through L2,
as for B6.

The plain version (:func:`shard_rhs_plain` and its two siblings) is B2's
plain RHS (``ops/fused_chunk.py::_rhs_plain``) and its clamped update over
one shard's tables, summing in the kernel's CSR order, so kernel and plain
agree bit for bit (``--fmad=false``). The wrappers launch the kernel for
CUDA tensors and the plain version for CPU tensors
(:func:`shard_stream_plain_tiled` on tiled ones); anything else raises.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays, _make_buckets, _round_up
from odesat_tpu_torch.cnf.formula import CNFFormula
from odesat_tpu_torch.constants import DT_MAX, DT_MIN, EPSILON
from odesat_tpu_torch.ops.fused_chunk import (
    SMEM_LIMIT_BYTES,
    ChunkSpec,
    ChunkTables,
    _clamp,
    _rhs_plain,
    cached_tables,
    check_chunk_config,
    chunk_tables,
    cuda_device,
    plain_tables,
    spec_fields,
)
from odesat_tpu_torch.ops.stream_chunk import load_library, occurrence_codes, raise_for
from odesat_tpu_torch.ops.tiles import TILE, Tiles, held_pool, n_tiles, rows_of, tile, untile

SPAN = 128  # the clause-segment alignment of the JAX layout, kept for array equality

# Kernel launches made through the B5 wrappers in this process (every
# mode). A plain integer that callers may reset; chip_smoke.py reads it to
# show that the clause-mesh path went through the kernel.
launches = 0

_MODES = {"rhs": 0, "fixed": 1, "second": 2}


@dataclass(frozen=True)
class ShardPlan:
    """The clause-sharded layout as the port's kernels read it: shard ``s``
    owns clause columns ``[s*mp_local, (s+1)*mp_local)``. ``tables[s]`` are
    its literal codes and its local CSR (``ops/fused_chunk.ChunkTables``
    over the shard's ``(K, mp_local)`` slots). ``clause_of`` maps every
    global column to its clause's index in the compiled formula (-1 at
    padding), so states of two shard counts can be compared clause by
    clause; None for a plan rebuilt from arrays alone."""

    n_shards: int
    mp_local: int
    n_vars_padded: int
    tables: tuple
    clause_of: Optional[np.ndarray] = None

    def occ_code(self, s: int) -> np.ndarray:
        """Shard ``s``'s occurrence codes ``2*m_local + negated``."""
        return occurrence_codes(self.tables[s])


def shard_slice(n_clauses_padded: int, n_shards: int, s: int) -> slice:
    """Shard ``s``'s columns of a clause axis split in ``n_shards`` equal
    contiguous segments."""
    per = n_clauses_padded // n_shards
    return slice(s * per, (s + 1) * per)


def build_shard_plan(fa, n_shards: int, clause_of=None) -> ShardPlan:
    """The per-shard tables of arrays laid out by :func:`compile_stream_sharded`
    (the JAX package's included: ``lit_var``, ``sign``, ``lit_mask``)."""
    K, Mp = fa.lit_var.shape
    if Mp % n_shards:
        raise ValueError(f"{Mp} clause columns do not split into {n_shards} shards")
    tables = []
    for s in range(n_shards):
        seg = shard_slice(Mp, n_shards, s)
        tables.append(chunk_tables(SimpleNamespace(
            lit_var=np.asarray(fa.lit_var)[:, seg], sign=np.asarray(fa.sign)[:, seg],
            lit_mask=np.asarray(fa.lit_mask)[:, seg], n_vars_padded=fa.n_vars_padded)))
    return ShardPlan(n_shards, Mp // n_shards, fa.n_vars_padded, tuple(tables), clause_of)


def compile_stream_sharded(
    formula: CNFFormula,
    n_shards: int,
    *,
    var_pad: int = 128,
    bucket: bool = True,
    min_bucket: int = 256,
    window_sort: bool = True,
    dtype=np.float32,
):
    """Compile a normalized formula for a clause mesh of ``n_shards``.
    Returns ``(FormulaArrays, ShardPlan)``. The arrays are those of the JAX
    package's ``compile_stream_sharded`` (:89-270), field for field: every
    width bucket splits contiguously into ``n_shards`` parts padded to one
    128-aligned length, so every shard has the same local layout, and the
    clause axis is shard 0's segment, then shard 1's, and so on. The
    arrays are an ordinary ``FormulaArrays`` (the scan path runs them
    unchanged); ``fa.shard_plan`` is the plan."""
    if any(len(c) == 0 for c in formula.clauses):
        raise ValueError("formula contains an empty clause (trivially UNSAT)")
    M = formula.num_clauses
    K = max(formula.max_clause_width, 1)
    N = formula.varnum
    widths = [len(c) for c in formula.clauses]

    if bucket and M and len(set(widths)) > 1:
        index_buckets = _make_buckets(widths, min_bucket)
    else:
        index_buckets = [list(range(M))]
    if window_sort:
        index_buckets = [
            sorted(ix, key=lambda i: min(lit.variable for lit in formula.clauses[i]))
            for ix in index_buckets
        ]

    local_meta = []  # (m0_local, m1_local, Kb)
    shard_parts = []  # per bucket: per-shard clause-index lists
    cursor = 0
    for indices in index_buckets:
        Kb = max((widths[i] for i in indices), default=1)
        per = -(-len(indices) // n_shards) if indices else 0
        parts = [indices[s * per: (s + 1) * per] for s in range(n_shards)]
        Mb = _round_up(max((len(p) for p in parts), default=0), SPAN)
        local_meta.append((cursor, cursor + Mb, Kb))
        shard_parts.append(parts)
        cursor += Mb
    Mp_local = cursor
    Mp = Mp_local * n_shards
    Np = _round_up(N, var_pad)

    lit_var = np.zeros((K, Mp), dtype=np.int32)
    sign = np.zeros((K, Mp), dtype=dtype)
    lit_mask = np.zeros((K, Mp), dtype=dtype)
    clause_mask = np.zeros((Mp,), dtype=dtype)
    xs_init = np.full((Mp,), 1.0, dtype=dtype)
    clause_of = np.full((Mp,), -1, dtype=np.int64)

    occurrences = [[] for _ in range(Np)]
    global_buckets = []
    slot_offset = 0
    for s in range(n_shards):
        base = s * Mp_local
        for (m0, m1, Kb), parts in zip(local_meta, shard_parts):
            Mb = m1 - m0
            for j, ci in enumerate(parts[s]):
                m = base + m0 + j
                clause = formula.clauses[ci]
                clause_mask[m] = 1.0
                clause_of[m] = ci
                xs_init[m] = 1.0 if any(lit.is_negated for lit in clause) else -1.0
                for k, lit in enumerate(clause):
                    lit_var[k, m] = lit.variable
                    sign[k, m] = -1.0 if lit.is_negated else 1.0
                    lit_mask[k, m] = 1.0
                    occurrences[lit.variable].append(slot_offset + k * Mb + j)
            global_buckets.append((base + m0, base + m1, Kb))
            slot_offset += Kb * Mb

    D = max((len(o) for o in occurrences), default=1) or 1
    var_occ = np.zeros((Np, D), dtype=np.int32)
    occ_mask = np.zeros((Np, D), dtype=dtype)
    for i, occ in enumerate(occurrences):
        if occ:
            var_occ[i, : len(occ)] = occ
            occ_mask[i, : len(occ)] = 1.0

    fa = FormulaArrays(
        lit_var=lit_var, sign=sign, lit_mask=lit_mask, clause_mask=clause_mask,
        xs_init=xs_init, var_occ=var_occ, occ_mask=occ_mask, n_vars=N, n_vars_padded=Np,
        n_clauses=M, n_clauses_padded=Mp, max_width=K, min_width=min(widths, default=1),
        max_occ=D, density=formula.clause_density(), bucket_slices=tuple(global_buckets),
        n_slots=slot_offset,
    )
    plan = build_shard_plan(fa, n_shards, clause_of)
    return dataclasses.replace(fa, shard_plan=plan), plan


def v_fits_one_cta(Np: int) -> bool:
    """One trajectory's ``v`` (f32), beside the 32-word reduction scratch,
    fits one CTA's shared memory: the need of the one-CTA-a-trajectory
    design B5's and B6's gate was written for, kept so that the same
    formulas take the kernels; the tiled kernels hold nothing of a
    trajectory in shared memory."""
    return 4 * (32 + Np) <= SMEM_LIMIT_BYTES


def stream_shard_supported(fa: FormulaArrays, plan: Optional[ShardPlan] = None,
                           dtype: str = "float32") -> bool:
    """B5's gate: a shard plan, no unit clauses (their infinite gradients
    are the scan path's business, ops/rhs.py), float32 state, and
    :func:`v_fits_one_cta`. It replaces the TPU kernel's 2 GiB plane and
    VMEM budgets (JAX :273-285); nothing here is a plane."""
    plan = plan if plan is not None else fa.shard_plan
    return (
        plan is not None
        and fa.min_width >= 2
        and dtype == "float32"
        and v_fits_one_cta(fa.n_vars_padded)
    )


@dataclass(frozen=True)
class ShardSpec(ChunkSpec):
    """One shard's tables and the integrator's constants on one device (a
    :class:`ChunkSpec` over the shard's clauses, which is what the plain
    version reads, plus the kernel's occurrence codes)."""

    occ_code: torch.Tensor  # (nnz,) int32, 2*m_local + negated
    pads: torch.Tensor  # (n,) int32, the shard's padded clauses, which have no occurrence


def shard_spec(fa: FormulaArrays, zeta: float, ode, device, shard: int = 0) -> ShardSpec:
    """Shard ``shard``'s spec. The clamp cap is the whole formula's
    (``XL_CAP_PER_CLAUSE`` times the real clause count, JAX :783)."""
    plan = fa.shard_plan
    t: ChunkTables = plan.tables[shard]
    seg = shard_slice(fa.n_clauses_padded, plan.n_shards, shard)
    local = SimpleNamespace(clause_mask=fa.clause_mask[seg], n_clauses=fa.n_clauses)
    device = cuda_device(device)
    pads = np.flatnonzero(t.lit_code[:t.Mp] < 0).astype(np.int32)
    return ShardSpec(**spec_fields(local, zeta, ode, device, t),
                     occ_code=torch.as_tensor(occurrence_codes(t)).to(device),
                     pads=torch.as_tensor(pads).to(device))


def _tables(spec: ShardSpec):
    return cached_tables(spec, plain_tables)


# ---------------------------------------------------------------- plain


def shard_rhs_plain(v, xs, xl, spec: ShardSpec):
    """``rhs`` mode: (dv partial, dxs, dxl, sat) over the shard's clauses."""
    return _rhs_plain(v, xs, xl, spec, _tables(spec))


def shard_fixed_plain(v, dt, xs, xl, spec: ShardSpec):
    """``fixed`` mode: (dv partial, xs', xl', sat) with the clamped Euler
    update of the shard's clause memories; ``dt`` (B,) is 0 for done rows."""
    dv, dxs, dxl, sat = _rhs_plain(v, xs, xl, spec, _tables(spec))
    dt_col = dt.unsqueeze(1)
    xs2 = _clamp(xs + dt_col * dxs, EPSILON, 1.0 - EPSILON)
    xl2 = _clamp(xl + dt_col * dxl, 1.0, spec.xl_cap)
    return dv, xs2, xl2, sat


def shard_second_plain(hv, dt, adv, xs, xl, dxs1, dxl1, spec: ShardSpec):
    """``second`` mode: the RHS at the half step ``hv`` with the half-step
    clause state recomputed from the first evaluation's ``dxs1``/``dxl1``;
    returns (dv partial, final xs, final xl, the shard's error) where rows
    with ``adv`` False keep their xs and xl (JAX :468-476, :536-551)."""
    dt_col = dt.unsqueeze(1)
    half = 0.5 * dt_col
    hxs = _clamp(xs + half * dxs1, EPSILON, 1.0 - EPSILON)
    hxl = _clamp(xl + half * dxl1, 1.0, spec.xl_cap)
    dv, dxs, dxl, _ = _rhs_plain(hv, hxs, hxl, spec, _tables(spec))
    txs = _clamp(hxs + half * dxs, EPSILON, 1.0 - EPSILON)
    txl = _clamp(hxl + half * dxl, 1.0, spec.xl_cap)
    fxs = _clamp(xs + dt_col * dxs1, EPSILON, 1.0 - EPSILON)
    fxl = _clamp(xl + dt_col * dxl1, 1.0, spec.xl_cap)
    err = torch.maximum((fxs - txs).abs().amax(dim=1), (fxl - txl).abs().amax(dim=1))
    keep = adv.unsqueeze(1)
    return dv, torch.where(keep, txs, xs), torch.where(keep, txl, xl), err


# ---------------------------------------------------------------- kernel


def _check(spec: ShardSpec, **tensors) -> int:
    """Raise ValueError unless every row-major tensor is on the spec's
    device, contiguous and of its expected shape and dtype; returns B."""
    B = tensors["v"].shape[0]
    want = {"v": (spec.Np,), "xs": (spec.Mp,), "xl": (spec.Mp,), "dxs1": (spec.Mp,),
            "dxl1": (spec.Mp,), "dt": (), "adv": ()}
    for name, t in tensors.items():
        dtype = torch.bool if name == "adv" else torch.float32
        shape = (B, *want[name])
        if t.device != spec.device:
            raise ValueError(f"{name} is on {t.device}, the shard's tables on {spec.device}")
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype}; the kernel takes a "
                             f"contiguous {shape} {dtype}")
    return B


# per mode: the tiled inputs a launch reads and the scratch buffers it writes
_READS = {"rhs": ("v", "xs", "xl"), "fixed": ("v", "dt", "xs", "xl"),
          "second": ("v", "dt", "adv", "xs", "xl", "dxs1", "dxl1")}
_WRITES = {"rhs": ("acc", "dxs1", "dxl1"), "fixed": ("acc", "xs2", "xl2"),
           "second": ("dv2", "xs2", "xl2", "err")}


def _rows(spec: ShardSpec, name: str) -> tuple:
    """The rows a tile of buffer ``name`` holds: (G, *rows, R)."""
    Np = (spec.Np,)
    return {"v": Np, "acc": (spec.Np + 1,), "dv2": Np, "dt": (), "adv": (), "err": (),
            "upd": Np, "fv": Np, "hv": Np, "tv": Np, "dte": (), "half": (), "flag": (),
            "err2": (), "ratio": ()}.get(name, (spec.Mp,))


_BOOLS = ("adv", "flag")


class ShardScratch:
    """The tiled buffers B5's launches write, allocated at first use and
    kept (:meth:`get`; :func:`make_clause_chunk` holds one a batch shape):
    ``acc`` (G, Np+1, R) = (dv partial | 1 - sat) of rhs and fixed;
    ``dxs1``, ``dxl1`` (G, Mp, R) of rhs; ``dv2`` (G, Np, R) and ``err``
    (G, R) of second; ``xs2``, ``xl2`` (G, Mp, R), the second copy of the
    clause memories that fixed and second write and swap with the launch's
    own xs, xl; and the step's torch updates' outputs (``upd``, ``fv``,
    ``hv``, ``tv`` (G, Np, R) f32; ``dte``, ``half``, ``err2``, ``ratio``
    (G, R) f32; ``adv``, ``flag`` (G, R) bool)."""

    def __init__(self, spec: ShardSpec, G: int):
        self.spec, self.G, self.bufs = spec, G, {}

    def get(self, name: str) -> torch.Tensor:
        t = self.bufs.get(name)
        if t is None:
            t = self.bufs[name] = torch.empty(
                (self.G, *_rows(self.spec, name), TILE), device=self.spec.device,
                dtype=torch.bool if name in _BOOLS else torch.float32)
        return t


def shard_stream_cuda(mode: str, spec: ShardSpec, v, xs, xl, dt=None, adv=None, dxs1=None,
                      dxl1=None, scratch: Optional[ShardScratch] = None) -> tuple:
    """Launch B5 once in ``mode`` on the current stream, on tiled buffers
    (``TILE`` trajectories a tile, ``ops/tiles.py``): v (hv for second)
    (G, Np, R), xs, xl, dxs1, dxl1 (G, Mp, R), dt (G, R) f32, adv (G, R)
    bool. Returns, tiled: rhs ``(acc, dxs1, dxl1)``, fixed ``(acc, xs',
    xl')``, second ``(dv2, xs', xl', err)``, with acc = (dv partial | 1 -
    sat). The outputs are ``scratch``'s buffers (a new scratch when None):
    fixed and second return the new clause memories in its second copy and
    take the given xs, xl into it, as B6 does. Raises if a buffer is not
    what the kernel takes or the launch is refused; never falls back."""
    global launches
    if spec.device.type != "cuda":
        raise ValueError(f"the shard RHS kernel runs on CUDA tensors, not {spec.device}")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    G, R = v.shape[0], v.shape[-1]
    if R != TILE:
        raise ValueError(f"tiles of {R} trajectories; the kernel takes {TILE}")
    if scratch is None:
        scratch = ShardScratch(spec, G)
    given = dict(v=v, xs=xs, xl=xl, dt=dt, adv=adv, dxs1=dxs1, dxl1=dxl1)
    bufs = dict(given, **{name: scratch.get(name) for name in _WRITES[mode]})
    for name in (*_READS[mode], *_WRITES[mode]):
        t, shape = bufs[name], (G, *_rows(spec, name), R)
        dtype = torch.bool if name == "adv" else torch.float32
        if t is None:
            raise ValueError(f"B5's {mode} mode needs the {name} buffer")
        if (t.device != spec.device or tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}; the kernel "
                             f"takes a contiguous {shape} {dtype} on {spec.device}")
    if mode != "rhs" and G and {bufs["xs2"].data_ptr(), bufs["xl2"].data_ptr()} & {
            xs.data_ptr(), xl.data_ptr()}:
        raise ValueError("the scratch's clause memories are the buffers' own: pass the "
                         "buffers a launch returned")
    outs = tuple(bufs[name] for name in _WRITES[mode])
    if G == 0:
        return outs
    lib, _ = load_library()

    def ptr(name):
        t = bufs.get(name)
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.shard_stream_launch(
            _MODES[mode], v.data_ptr(), ptr("dt"), ptr("adv"), xs.data_ptr(), xl.data_ptr(),
            ptr("xs2"), ptr("xl2"), ptr("dxs1"), ptr("dxl1"), outs[0].data_ptr(), ptr("err"),
            spec.pads.data_ptr(), spec.pads.numel(), spec.lit_code.data_ptr(),
            spec.occ_ptr.data_ptr(), spec.occ_code.data_ptr(), G, R, spec.Np, spec.Mp, spec.K,
            int(spec.paper), int(spec.bf16), spec.zeta, spec.xl_cap, stream,
        )
    raise_for(lib, rc, f"shard RHS kernel ({mode})")
    launches += 1
    if mode != "rhs":
        scratch.bufs["xs2"], scratch.bufs["xl2"] = xs, xl
    return outs


def _flag(dv, sat):
    """(dv | 1 - sat), the buffer the clause group all-reduces."""
    return torch.cat([dv, (~sat).to(dv.dtype).unsqueeze(1)], dim=1)


def shard_stream_plain_tiled(mode: str, spec: ShardSpec, v, xs, xl, dt=None, adv=None,
                             dxs1=None, dxl1=None) -> tuple:
    """:func:`shard_stream_cuda`'s outputs from the plain versions: the
    tiled buffers untiled with their padding rows, run, tiled again (new
    tensors)."""
    R, rows = v.shape[-1], rows_of(v)

    def u(t):
        return None if t is None else untile(t, rows)

    if mode == "rhs":
        dv, dxs, dxl, sat = shard_rhs_plain(u(v), u(xs), u(xl), spec)
        out = (_flag(dv, sat), dxs, dxl)
    elif mode == "fixed":
        dv, xs2, xl2, sat = shard_fixed_plain(u(v), u(dt), u(xs), u(xl), spec)
        out = (_flag(dv, sat), xs2, xl2)
    elif mode == "second":
        out = shard_second_plain(u(v), u(dt), u(adv), u(xs), u(xl), u(dxs1), u(dxl1), spec)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return tuple(tile(t, R) for t in out)


def shard_stream_tiled(mode: str, spec: ShardSpec, v, xs, xl, dt=None, adv=None, dxs1=None,
                       dxl1=None, scratch: Optional[ShardScratch] = None) -> tuple:
    """One pass in ``mode`` on tiled buffers: B5 for CUDA buffers, its
    plain version for CPU buffers; anything else raises."""
    kind = v.device.type
    if kind == "cuda":
        return shard_stream_cuda(mode, spec, v, xs, xl, dt, adv, dxs1, dxl1, scratch)
    if kind == "cpu":
        return shard_stream_plain_tiled(mode, spec, v, xs, xl, dt, adv, dxs1, dxl1)
    raise ValueError(f"no shard RHS path for tensors on {v.device}")


_FILL = dict(xs=0.5, xl=1.0, adv=False)  # padding rows: xs inside [eps, 1 - eps], no NaN or inf


def _rows_through_tiles(mode: str, spec: ShardSpec, **given) -> tuple:
    """B5 on row-major CUDA tensors: tiled copies, one launch, the outputs
    untiled, as the plain version of ``mode`` returns them."""
    B = _check(spec, **{k: t for k, t in given.items() if t is not None})
    tiled = {k: None if t is None else tile(t, fill=_FILL.get(k, 0)) for k, t in given.items()}
    out = shard_stream_cuda(mode, spec, **tiled)
    if mode == "second":
        return tuple(untile(t, B) for t in out)
    acc, Np = out[0], spec.Np
    return (untile(acc[:, :Np], B), untile(out[1], B), untile(out[2], B),
            untile(acc[:, Np], B) == 0)


def _route(v):
    kind = v.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no shard RHS path for tensors on {v.device}")
    return kind == "cuda"


def shard_rhs(v, xs, xl, spec: ShardSpec):
    """``rhs`` mode on rows as they are: B5 (CUDA tensors, through tiled
    copies) or its plain version (CPU)."""
    if _route(v):
        return _rows_through_tiles("rhs", spec, v=v, xs=xs, xl=xl)
    return shard_rhs_plain(v, xs, xl, spec)


def shard_fixed(v, dt, xs, xl, spec: ShardSpec):
    """``fixed`` mode on rows as they are; returns new xs, xl."""
    if _route(v):
        return _rows_through_tiles("fixed", spec, v=v, dt=dt, xs=xs, xl=xl)
    return shard_fixed_plain(v, dt, xs, xl, spec)


def shard_second(hv, dt, adv, xs, xl, dxs1, dxl1, spec: ShardSpec):
    """``second`` mode on rows as they are; returns new xs, xl."""
    if _route(hv):
        return _rows_through_tiles("second", spec, v=hv, dt=dt, adv=adv, xs=xs, xl=xl,
                                   dxs1=dxs1, dxl1=dxl1)
    return shard_second_plain(hv, dt, adv, xs, xl, dxs1, dxl1, spec)


# ---------------------------------------------------------------- steps


def make_stream_shard_rhs(fa: FormulaArrays, zeta: float, ode, device, shard: int = 0):
    """``rhs(v, xs, xl) -> (dv partial, dxs, dxl, sat)`` for shard ``shard``'s
    clause segment (JAX :719); the caller sums dv and ANDs sat over the
    clause group."""
    spec = shard_spec(fa, zeta, ode, device, shard)

    def rhs(v, xs, xl):
        return shard_rhs(v, xs, xl, spec)

    rhs.spec = spec
    return rhs


# a padding row of B5's tiles: done, with dt 0, xs 0.5 and xl 1, so that no
# NaN or inf enters a max or a sum; untiling drops it
STATE_FILLS = dict(xs=_FILL["xs"], xl=_FILL["xl"], done=True)


def tile_state(state):
    """Tiled copies of an ODE state's fields (``ops/tiles.py``), padded
    with :data:`STATE_FILLS`."""
    return type(state)(*(tile(t, fill=STATE_FILLS.get(name, 0))
                         for name, t in state._asdict().items()))


def untile_state(state, B: int):
    return type(state)(*(untile(t, B) for t in state))


def make_fused_clause_step(fa: FormulaArrays, zeta: float, ode, clause_group=None,
                           device="cuda"):
    """``step(state, dev=None) -> state`` for this rank's trajectory rows and
    clause segment (JAX :744-854): B5 evaluates the segment, the partial dv
    with the negated sat flag beside it is summed over ``clause_group`` by
    B7's standalone call (``ops/butterfly.py``: its kernel for CUDA tensors,
    its plain version, a gloo gather and the host tree, for CPU tensors), and
    the v update, dt control and done latch run in torch. The adaptive
    error is combined by the same call with the whole buffer a max zone.
    Fixed mode is one launch a step, adaptive two with the sum between them.
    The sums are B7's tree, so this path and B6's agree bit for bit at any
    S. The shard is the rank's index in ``clause_group`` (0 without a
    group).

    The work runs on tiled state: ``step.tiled(ts, scratch=None) -> ts``
    advances a state of tiled tensors (:func:`tile_state`) one step in
    place (the tiles of v, dt and done are updated, xs and xl come back
    where the launch left them), with dt as (G, 1, R) against the (G, X, R)
    rows and the error's max over the row axis, writing every other result
    into ``scratch`` (:class:`ShardScratch`; a new one when None);
    ``step`` itself tiles copies, steps and untiles, and writes nothing of
    the caller's state. :func:`make_clause_chunk` tiles once a chunk."""
    from odesat_tpu_torch.models.ode import ODEState
    from odesat_tpu_torch.parallel.dist import mesh_reduce

    plan = fa.shard_plan
    if plan is None:
        raise ValueError("needs a compile_stream_sharded formula (shard plan)")
    if ode.step_size is None and ode.dt_mode != "per-trajectory":
        raise ValueError(
            "the clause-shard kernel supports per-trajectory dt only; "
            "dt_mode='shared' runs on the scan path"
        )
    check_chunk_config(ode, "clause-shard kernel")
    if fa.min_width < 2:
        raise ValueError("the clause-shard kernel cannot represent unit-clause infinite "
                         "gradients; use the scan path")
    shard = 0
    if clause_group is not None:
        import torch.distributed as dist

        shard = dist.get_rank(clause_group)
        if dist.get_world_size(clause_group) != plan.n_shards:
            raise ValueError(f"the plan has {plan.n_shards} shards but the clause group "
                             f"{dist.get_world_size(clause_group)} ranks")
    spec = shard_spec(fa, zeta, ode, device, shard)
    Np = spec.Np
    # the step's constants on the device once: a scalar tensor made from the
    # host every step would copy it there and wait for the card each time
    c = {name: torch.tensor(float(x), dtype=torch.float32, device=spec.device) for name, x in
         dict(lo=-1.0, hi=1.0, zero=0.0, dt=ode.step_size or 0.0, tol=ode.tolerance,
              dt_min=DT_MIN, dt_max=DT_MAX).items()}

    def reduce(t, op="sum"):
        """``t`` combined over the clause group in place (B7): summed, or
        (``op`` "max") the whole buffer a max zone."""
        if clause_group is not None:
            mesh_reduce(t, clause_group, op)

    def clamp_(x):  # _clamp's operations, in place
        return torch.fmin(torch.fmax(x, c["lo"], out=x), c["hi"], out=x)

    def clamp_dt_(x):
        return torch.fmin(torch.fmax(x, c["dt_min"], out=x), c["dt_max"], out=x)

    # the updates write into the scratch's buffers and the state's own
    # tiles (the operations of JAX's clamp(v + dt * dv) and the rest, in
    # its order), so that a chunk allocates nothing on the card
    if ode.step_size is not None:

        def tiled(ts, scratch=None):
            w = scratch if scratch is not None else ShardScratch(spec, ts.v.shape[0])
            dt_eff = torch.where(ts.done, c["zero"], c["dt"], out=w.get("dte"))
            acc, xs, xl = shard_stream_tiled("fixed", spec, ts.v, ts.xs, ts.xl, dt=dt_eff,
                                             scratch=w)
            reduce(acc)
            upd = torch.mul(dt_eff.unsqueeze(1), acc[:, :Np], out=w.get("upd"))
            v = clamp_(torch.add(ts.v, upd, out=ts.v))
            allsat = torch.eq(acc[:, Np], 0, out=w.get("flag"))
            return ODEState(v, xs, xl, ts.dt, torch.bitwise_or(ts.done, allsat, out=ts.done))
    else:

        def tiled(ts, scratch=None):
            w = scratch if scratch is not None else ShardScratch(spec, ts.v.shape[0])
            acc, dxs1, dxl1 = shard_stream_tiled("rhs", spec, ts.v, ts.xs, ts.xl, scratch=w)
            reduce(acc)
            dv1 = acc[:, :Np]
            allsat = torch.eq(acc[:, Np], 0, out=w.get("flag"))
            # ~done & ~allsat (src/system.rs:122)
            advance = torch.bitwise_or(ts.done, allsat, out=w.get("adv")).bitwise_not_()
            dt = ts.dt
            dt_c = dt.unsqueeze(1)
            half = torch.mul(dt, 0.5, out=w.get("half")).unsqueeze(1)
            fv = w.get("fv")
            clamp_(torch.add(ts.v, torch.mul(dt_c, dv1, out=fv), out=fv))
            hv = w.get("hv")
            clamp_(torch.add(ts.v, torch.mul(half, dv1, out=hv), out=hv))
            dv2, xs, xl, err_sl = shard_stream_tiled("second", spec, hv, ts.xs, ts.xl, dt=dt,
                                                     adv=advance, dxs1=dxs1, dxl1=dxl1,
                                                     scratch=w)
            reduce(dv2)
            tv = w.get("tv")
            clamp_(torch.add(hv, torch.mul(half, dv2, out=tv), out=tv))
            err = w.get("err2")
            torch.amax(torch.sub(fv, tv, out=fv).abs_(), dim=1, out=err)
            err = torch.maximum(err_sl, err, out=err)
            reduce(err, "max")
            # err == 0 -> dt hits the ceiling (src/system.rs:132-135); a tensor
            # numerator, since `float / tensor` rounds twice in torch
            ratio = torch.clamp_min(err, 1e-30, out=w.get("ratio"))
            ratio = torch.sqrt(torch.div(c["tol"], ratio, out=ratio), out=ratio)
            new_dt = clamp_dt_(torch.mul(dt, ratio, out=ratio))
            v = torch.where(advance.unsqueeze(1), tv, ts.v, out=ts.v)
            dt = torch.where(advance, new_dt, dt, out=ts.dt)
            return ODEState(v, xs, xl, dt, torch.bitwise_or(ts.done, allsat, out=ts.done))

    def step(state, dev=None):
        return untile_state(tiled(tile_state(state)), state.v.shape[0])

    def calls(ts) -> list:
        """B7's calls over the clause group in one step from the tiled state
        ``ts``, in order: the (dv | 1 - sat) sum; adaptive, also the second
        evaluation's dv and the error's max."""
        G = ts.v.shape[0]
        f32 = torch.float32
        out = [(clause_group, (G, Np + 1, TILE), f32)]
        if ode.step_size is None:
            out += [(clause_group, (G, Np, TILE), f32), (clause_group, (G, TILE), f32)]
        return out

    step.tiled, step.spec, step.fa, step.calls = tiled, spec, fa, calls
    return step


def make_clause_chunk(step, chunk_steps: int):
    """``run(state, dev=None) -> state``: ``chunk_steps`` calls of a clause
    step's ``tiled`` on the state tiled once at entry and untiled once at
    exit, every launch and torch update writing into a
    :class:`ShardScratch`: on a CUDA state one capture of the steps, their
    B7 sums included, replayed (``ops/scan_chunk.TiledChunk``), as JAX
    jits the chunk into one ``lax.scan`` (JAX :340-358 and, on a clause
    mesh, ``odesat_tpu/parallel/sharded.py:597-624``); on a CPU state the
    steps from Python, the plain version (inside
    ``ops/scan_chunk.host_paced()`` on the card too).

    The call consumes its input, as JAX's ``donate_argnums=0`` on the mesh
    runners (``ops/device_loop.py`` states the contract): the rows are
    tiled in the caller's own storage (``ops/tiles.py``; a ragged batch,
    or a field that cannot be tiled where it lies, through buffers held
    for its shape), the steps update them there, and the result is untiled
    into it, so the returned state's tensors are the input's. The tiles'
    buffers and the scratch are held for each batch shape in the formula's
    pool (``ops/tiles.held_pool``), which the runners of every chunk
    length share: a second call of a shape, by this runner or another of
    the formula's, allocates nothing on the card."""
    from odesat_tpu_torch.ops.scan_chunk import TiledChunk

    spec = step.spec
    # ("B5", the shard's widths, batch, device) -> (Tiles, ShardScratch, its own xs2 and xl2)
    held = held_pool(step.fa)
    chunks: dict = {}  # the same key -> this runner's chunk on those buffers

    def run(state, dev=None):
        B, device = state.v.shape[0], state.v.device
        key = ("B5", spec.Np, spec.Mp, B, device)
        h = held.get(key)
        if h is None:
            scratch = ShardScratch(spec, n_tiles(B))
            own = (scratch.get("xs2"), scratch.get("xl2")) if device.type == "cuda" else None
            h = held[key] = Tiles(), scratch, own
        chunk = chunks.get(key)
        if chunk is None:
            tiles, scratch, own = h

            def restore():
                if own is not None:
                    scratch.bufs["xs2"], scratch.bufs["xl2"] = own

            chunk = chunks[key] = TiledChunk(lambda ts, dev: step.tiled(ts, scratch),
                                             chunk_steps, device, tiles, STATE_FILLS, restore,
                                             step.calls)
        return chunk(state, dev)

    run.step, run.held, run.chunks = step, held, chunks
    return run


def make_single_device_runner(fa: FormulaArrays, zeta: float, ode, chunk_steps: int,
                              device="cuda"):
    """``run(state, dev=None) -> state`` driving the clause step at S=1 on
    one device (JAX :340): the per-shard building block of the clause-mesh
    path, runnable and measurable without a mesh. ``fa`` must come from
    :func:`compile_stream_sharded` with ``n_shards=1``."""
    plan = fa.shard_plan
    if plan is None or plan.n_shards != 1:
        raise ValueError("needs a compile_stream_sharded(n_shards=1) formula")
    return make_clause_chunk(make_fused_clause_step(fa, zeta, ode, device=device), chunk_steps)
