"""One clause shard's ODE right-hand side (kernel B5): the clause-sharded
compile, a hand-written CUDA kernel for Hopper, its plain torch version and
the clause-mesh step built on it.

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
  shard's xs and xl written in place (dt is 0 for done rows);
* ``second``: the adaptive second evaluation at the half step ``hv``: the
  half-step clause state is recomputed from the first launch's dxs/dxl,
  the final xs/xl are written in place under the advance flag, and the
  shard's part of the step-doubling error comes out.

The v update, dt control and done latch run in torch after the all-reduce
(:func:`make_fused_clause_step`, the port of the TPU module's :744-854).

Design for the card (``shard_stream_launch`` in ``csrc/stream_chunk.cu``,
beside B2 and B10, sharing their clause- and variable-phase device code):
one CTA per trajectory. The TPU kernel streams sign-baked one-hot planes
per 128-clause span through VMEM and runs the gather and the scatter as
matmuls; none of that carries over, so the port's plan holds no planes,
window offsets or biases. A shard's tables are a literal code per
``(k, m_local)`` slot and, per variable, a CSR list of its occurrences in
the shard's clauses (``2*m_local + negated``), in the global CSR order
restricted to the shard: what B2 reads, cut to one segment. They are read
from global memory, where every CTA reads the same bytes and they stay in
L2. ``v`` lives in shared memory; the clause words (running min, second
min) and, in ``second`` mode, the half-step clause state too while they
fit (:func:`shard_layout`), else in a scratch row per trajectory. The
variable phase sums each variable's shard-local list in CSR order, with no
atomics.

What bounds it: device-memory bytes. Unlike the chunk kernels, the state
crosses device memory every step: ``fixed`` reads v, xs and xl and writes
dv, xs and xl, about 0.8 GB a step at the config-7 instance (Np=10240,
Mp=43,776) and B=1024, 0.24 ms at 3.35 TB/s; where the clause words do
not fit the CTA (S=1 there: 350 KB a trajectory), their scratch rows add
about as much again. What the design does about it: one launch a fixed
step, with the clause-memory update fused in place (as the TPU aliases
them) so xs and xl cross memory once each way; the half-step clause state
of ``second`` is recomputed from the first launch's derivatives instead of
being stored; the tables stay in L2.

The plain version (:func:`shard_rhs_plain` and its two siblings) is B2's
plain RHS (``ops/fused_chunk.py::_rhs_plain``) and its clamped update over
one shard's tables, summing in the kernel's CSR order, so kernel and plain
agree bit for bit (``--fmad=false``). The wrappers launch the kernel for
CUDA tensors and the plain version for CPU tensors; anything else raises.
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
from odesat_tpu_torch.ops.stream_chunk import (
    Layout,
    kernel_threads,
    load_library,
    occurrence_codes,
    place_arg,
    place_items,
    raise_for,
)

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


def shard_layout(Np: int, Mp: int, second: bool) -> Optional[Layout]:
    """B5's placement: ``v`` resident in shared memory, then the clause
    words m1 and m2, then (``second`` mode) the half-step xs and xl, each
    in shared memory while it fits, else in the scratch row."""
    sizes = dict(v=Np, m1=Mp, m2=Mp)
    if second:
        sizes.update(hxs=Mp, hxl=Mp)
    return place_items(sizes, 4)


def stream_shard_supported(fa: FormulaArrays, plan: Optional[ShardPlan] = None,
                           dtype: str = "float32") -> bool:
    """B5's gate: a shard plan, no unit clauses (their infinite gradients
    are the scan path's business, ops/rhs.py), float32 state, and ``v`` in
    one CTA's shared memory. It replaces the TPU kernel's 2 GiB plane and
    VMEM budgets (JAX :273-285); nothing here is a plane."""
    plan = plan if plan is not None else fa.shard_plan
    return (
        plan is not None
        and fa.min_width >= 2
        and dtype == "float32"
        and shard_layout(fa.n_vars_padded, plan.mp_local, True) is not None
    )


@dataclass(frozen=True)
class ShardSpec(ChunkSpec):
    """One shard's tables and the integrator's constants on one device (a
    :class:`ChunkSpec` over the shard's clauses, which is what the plain
    version reads, plus the kernel's occurrence codes)."""

    occ_code: torch.Tensor  # (nnz,) int32, 2*m_local + negated


def shard_spec(fa: FormulaArrays, zeta: float, ode, device, shard: int = 0) -> ShardSpec:
    """Shard ``shard``'s spec. The clamp cap is the whole formula's
    (``XL_CAP_PER_CLAUSE`` times the real clause count, JAX :783)."""
    plan = fa.shard_plan
    t: ChunkTables = plan.tables[shard]
    seg = shard_slice(fa.n_clauses_padded, plan.n_shards, shard)
    local = SimpleNamespace(clause_mask=fa.clause_mask[seg], n_clauses=fa.n_clauses)
    device = cuda_device(device)
    return ShardSpec(**spec_fields(local, zeta, ode, device, t),
                     occ_code=torch.as_tensor(occurrence_codes(t)).to(device))


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
    """Raise ValueError unless every tensor is on the spec's device,
    contiguous and of its expected shape and dtype; returns B."""
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


def shard_stream_cuda(mode: str, spec: ShardSpec, v, xs, xl, dt=None, adv=None, dxs1=None,
                      dxl1=None):
    """Launch B5 once in ``mode`` on the current stream of the tensors'
    device. ``fixed`` and ``second`` write xs and xl in place. Returns the
    mode's outputs as the plain versions do. Raises if an input is not what
    the kernel takes or the launch is refused; never falls back."""
    global launches
    if spec.device.type != "cuda":
        raise ValueError(f"the shard RHS kernel runs on CUDA tensors, not {spec.device}")
    given = dict(v=v, xs=xs, xl=xl, dt=dt, adv=adv, dxs1=dxs1, dxl1=dxl1)
    B = _check(spec, **{k: t for k, t in given.items() if t is not None})
    dv = torch.empty_like(v)
    red = torch.empty(B, dtype=torch.float32, device=spec.device)
    dxs = dxl = None
    if mode == "rhs":
        dxs, dxl = torch.empty_like(xs), torch.empty_like(xl)
    if B:
        layout = shard_layout(spec.Np, spec.Mp, mode == "second")
        scratch = torch.empty((B * layout.row_words) or 1, dtype=torch.float32,
                              device=spec.device)
        adv_u8 = adv.to(torch.uint8) if adv is not None else None
        lib, _ = load_library()

        def ptr(t):
            return t.data_ptr() if t is not None else None

        with torch.cuda.device(spec.device):
            stream = torch.cuda.current_stream(spec.device).cuda_stream
            rc = lib.shard_stream_launch(
                _MODES[mode], v.data_ptr(), ptr(dt), ptr(adv_u8), xs.data_ptr(), xl.data_ptr(),
                ptr(dxs1), ptr(dxl1), dv.data_ptr(), ptr(dxs), ptr(dxl), red.data_ptr(),
                spec.lit_code.data_ptr(), spec.occ_ptr.data_ptr(), spec.occ_code.data_ptr(),
                scratch.data_ptr(), place_arg(layout), layout.row_words, layout.smem_bytes,
                B, spec.Np, spec.Mp, spec.K, int(spec.paper), int(spec.bf16),
                kernel_threads(spec.Mp), spec.zeta, spec.xl_cap, stream,
            )
        raise_for(lib, rc, f"shard RHS kernel ({mode})")
        launches += 1
    if mode == "rhs":
        return dv, dxs, dxl, red > 0.5
    if mode == "fixed":
        return dv, xs, xl, red > 0.5
    return dv, xs, xl, red


def _route(v):
    kind = v.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no shard RHS path for tensors on {v.device}")
    return kind == "cuda"


def shard_rhs(v, xs, xl, spec: ShardSpec):
    """``rhs`` mode through B5 (CUDA tensors) or its plain version (CPU)."""
    if _route(v):
        return shard_stream_cuda("rhs", spec, v, xs, xl)
    return shard_rhs_plain(v, xs, xl, spec)


def shard_fixed(v, dt, xs, xl, spec: ShardSpec):
    """``fixed`` mode; on CUDA xs and xl are updated in place."""
    if _route(v):
        return shard_stream_cuda("fixed", spec, v, xs, xl, dt=dt)
    return shard_fixed_plain(v, dt, xs, xl, spec)


def shard_second(hv, dt, adv, xs, xl, dxs1, dxl1, spec: ShardSpec):
    """``second`` mode; on CUDA xs and xl are updated in place."""
    if _route(hv):
        return shard_stream_cuda("second", spec, hv, xs, xl, dt=dt, adv=adv, dxs1=dxs1,
                                 dxl1=dxl1)
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


def make_fused_clause_step(fa: FormulaArrays, zeta: float, ode, clause_group=None,
                           device="cuda"):
    """``step(state, dev=None) -> state`` for this rank's trajectory rows and
    clause segment (JAX :744-854): B5 evaluates the segment, the partial dv
    (with the negated sat flag packed beside it) is all-reduced over
    ``clause_group`` (SUM), and the v update, dt control and done latch run
    in torch. The adaptive error is all-reduced with MAX. Fixed mode is one
    launch a step, adaptive two with the all-reduce between them. The shard
    is the rank's index in ``clause_group`` (0 without a group). On CUDA the
    step writes the state's xs and xl in place."""
    from odesat_tpu_torch.models.ode import ODEState
    from odesat_tpu_torch.parallel.dist import all_reduce

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

    def reduce_dv_sat(dv, sat):
        if clause_group is None:
            return dv, sat
        buf = all_reduce(torch.cat([dv, (~sat).to(dv.dtype).unsqueeze(1)], dim=1),
                         clause_group)
        return buf[:, :-1], buf[:, -1] == 0

    def clamp_v(x):
        return _clamp(x, -1.0, 1.0)

    if ode.step_size is not None:
        dt_fixed = float(ode.step_size)

        def step(state, dev=None):
            dt_eff = torch.where(state.done, 0.0, state.v.new_tensor(dt_fixed))
            dv, xs2, xl2, sat = shard_fixed(state.v, dt_eff, state.xs, state.xl, spec)
            dv, allsat = reduce_dv_sat(dv, sat)
            v2 = clamp_v(state.v + dt_eff.unsqueeze(1) * dv)
            return ODEState(v2, xs2, xl2, state.dt, state.done | allsat)

        step.spec = spec
        return step

    tol = float(ode.tolerance)

    def step(state, dev=None):
        dv1, dxs1, dxl1, sat = shard_rhs(state.v, state.xs, state.xl, spec)
        dv1, allsat = reduce_dv_sat(dv1, sat)
        advance = ~state.done & ~allsat  # src/system.rs:122
        dt = state.dt
        dt_c = dt.unsqueeze(1)
        half = 0.5 * dt_c
        fv = clamp_v(state.v + dt_c * dv1)
        hv = clamp_v(state.v + half * dv1)
        dv2, xs_fin, xl_fin, err_sl = shard_second(hv, dt, advance, state.xs, state.xl,
                                                   dxs1, dxl1, spec)
        if clause_group is not None:
            dv2 = all_reduce(dv2, clause_group)
        tv = clamp_v(hv + half * dv2)
        err = torch.maximum(err_sl, (fv - tv).abs().amax(dim=1))
        if clause_group is not None:
            err = all_reduce(err, clause_group, op="max")
        # err == 0 -> dt hits the ceiling (src/system.rs:132-135); a tensor
        # numerator, since `float / tensor` rounds twice in torch
        ratio = err.new_tensor(tol) / err.clamp_min(1e-30)
        new_dt = _clamp(dt * torch.sqrt(ratio), DT_MIN, DT_MAX)
        v_fin = torch.where(advance.unsqueeze(1), tv, state.v)
        dt_fin = torch.where(advance, new_dt, dt)
        return ODEState(v_fin, xs_fin, xl_fin, dt_fin, state.done | allsat)

    step.spec = spec
    return step


def make_clause_chunk(step, chunk_steps: int):
    """``run(state, dev=None) -> state``: ``chunk_steps`` calls of a clause
    step. xs and xl are copied once at the start, so the in-place updates
    of the kernel never reach the caller's state."""

    def run(state, dev=None):
        state = state._replace(xs=state.xs.clone(), xl=state.xl.clone())
        for _ in range(chunk_steps):
            state = step(state, dev)
        return state

    run.step = step
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
