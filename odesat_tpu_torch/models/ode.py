"""The continuous-time SAT engine in PyTorch: batched Euler integration.

The port of ``odesat_tpu.models.ode``, with the same state, integrators
and entry points:

* **Trajectories are a batch axis**: the state ``(v, xs, xl, dt, done)``
  carries a leading batch dimension, and the reference's ``inter`` mode
  is the same code path with B > 1.
* **Per-trajectory adaptive dt** by default; ``dt_mode="shared"`` adapts
  one dt from the batch-max error like the reference's inter mode.
* **Early exit between chunks**: the host runs chunks of steps and checks
  the per-trajectory ``done`` flags after each; solved trajectories are
  frozen inside a chunk, so their satisfying sign pattern is kept exactly.
* **On CUDA the chunk is one kernel launch** when the formula and config
  allow it: the resident kernel B1 (ops/fused_chunk.py), else the
  large-formula kernel B2 (ops/stream_chunk.py); otherwise the scan
  chunk (ops/scan_chunk.py): single steps of the torch twin (ops/rhs.py),
  or with ``dv_strategy="pallas"`` of the RHS kernel B10
  (ops/rhs_kernel.py) and the torch update, captured as one CUDA graph;
  on the CPU the same steps in a Python loop. A multi-chunk dispatch of
  any of them on CUDA is one graph launch (ops/device_loop.py).
* **On a mesh** (``parallel/``, one rank per process) the batch splits
  over the ``traj`` axis and the clause axis over the ``clause`` axis; a
  clause mesh steps through the clause-shard kernel B5
  (ops/shard_stream.py) or the twin's clause step, with the partial dv
  all-reduced over the clause group. A trajectory-only mesh's dispatch of
  B1 or B2 on one host is one graph launch a rank, the ranks exchanging
  the stop on the card (parallel/sharded.make_sharded_multi_runner).

Step semantics preserved from the reference:

* fixed step: the clamped update is applied **even on the step where
  allsat is detected**, then the trajectory freezes
  (src/system.rs:141-154);
* adaptive step (step doubling): one full-dt trial step vs two half-dt
  steps with a mid-point derivative re-evaluation; inf-norm error over
  all three state arrays; ``dt <- clip(dt*sqrt(tol/err), 2^-7, 1e3)``;
  a satisfied state is *not* advanced (src/system.rs:111-139).

``SolverConfig``'s checkpoint cadence, ``resume_from`` and ``profile_dir``
work as in the JAX package (``utils/checkpoint.py``, ``models/loop.py``);
ODE snapshots load in either package.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays, compile_formula
from odesat_tpu_torch.cnf.formula import CNFFormula
from odesat_tpu_torch.constants import DT_INIT, DT_MAX, DT_MIN, EPSILON, XL_CAP_PER_CLAUSE
from odesat_tpu_torch.ops import rhs as rhs_ops
from odesat_tpu_torch.parallel.dist import fetch
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig
from odesat_tpu_torch.utils.logging import logger, span

# Bytes that :func:`simulate_batch`'s readouts copied to the host (the
# assignment and the done flags, as fetched), in this process: a plain
# integer that callers may reset.
readout_bytes = 0


class ODEState(NamedTuple):
    """Integrator state, batched over the leading axis.

    v: (B, Np) variable values; xs/xl: (B, Mp) clause memories;
    dt: (B,) per-trajectory step size; done: (B,) bool allsat latches.
    """

    v: torch.Tensor
    xs: torch.Tensor
    xl: torch.Tensor
    dt: torch.Tensor
    done: torch.Tensor


class FormulaDevice(NamedTuple):
    """The formula's incidence arrays on the state's device, passed to the
    step function (index arrays int64 for torch indexing)."""

    lit_var: torch.Tensor  # (K, Mp) int64
    sign: torch.Tensor  # (K, Mp)
    lit_mask: torch.Tensor  # (K, Mp)
    clause_mask: torch.Tensor  # (Mp,)
    var_occ: torch.Tensor  # (Np, D) int64
    occ_mask: torch.Tensor  # (Np, D)


def state_dtype(ode: ODEConfig) -> torch.dtype:
    """The state dtype; unlike the JAX package, float64 needs no
    process-wide switch."""
    return torch.float64 if ode.dtype == "float64" else torch.float32


def formula_device(fa: FormulaArrays, device, dtype=torch.float32) -> FormulaDevice:
    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return FormulaDevice(
        lit_var=put(fa.lit_var, torch.int64),
        sign=put(fa.sign, dtype),
        lit_mask=put(fa.lit_mask, dtype),
        clause_mask=put(fa.clause_mask, dtype),
        var_occ=put(fa.var_occ, torch.int64),
        occ_mask=put(fa.occ_mask, dtype),
    )


@dataclass
class SolveResult:
    """Outcome of a batched solve."""

    assignment: np.ndarray  # (B, n_vars) bool readout sign(v) > 0
    done: np.ndarray  # (B,) bool — trajectory reached allsat
    steps: int  # steps run per trajectory
    solved_index: Optional[int]  # first done trajectory, else None
    wall_time_s: float = 0.0
    harvested: Any = None  # what the harvest hook returned when it stopped the run

    @property
    def any_solved(self) -> bool:
        return self.solved_index is not None

    def best_assignment(self) -> np.ndarray:
        """First satisfied trajectory's readout, else trajectory 0
        (reference: src/system.rs:353-358)."""
        idx = self.solved_index if self.solved_index is not None else 0
        return self.assignment[idx]


def init_state(
    fa: FormulaArrays,
    batch_size: int,
    generator: Optional[torch.Generator],
    ode: ODEConfig,
    device,
    v0: Optional[np.ndarray] = None,
) -> ODEState:
    """Fresh trajectory batch: v ~ U(-1, 1) drawn from ``generator`` (a
    ``torch.Generator`` on ``device``), xs from the all-false clause
    valuation, xl = 1, dt = 0.01 (reference: src/main.rs:170-174,
    src/system.rs:205, 362-372). ``v0`` (numpy) replaces the draw and is
    broadcast over the batch."""
    dtype = state_dtype(ode)
    shape = (batch_size, fa.n_vars_padded)
    if v0 is not None:
        v = torch.as_tensor(np.asarray(v0)).to(device=device, dtype=dtype).expand(shape).clone()
    else:
        u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
        v = 2.0 * u - 1.0
    xs = (
        torch.as_tensor(fa.xs_init)
        .to(device=device, dtype=dtype)
        .expand(batch_size, fa.n_clauses_padded)
        .clone()
    )
    xl = torch.ones(batch_size, fa.n_clauses_padded, device=device, dtype=dtype)
    dt = torch.full((batch_size,), DT_INIT, device=device, dtype=dtype)
    done = torch.zeros(batch_size, device=device, dtype=torch.bool)
    return ODEState(v, xs, xl, dt, done)


def _scan_strategy(fa: FormulaArrays) -> str:
    # wide occurrence tables make the variable-major gather pay N*D >> nnz;
    # scatter-add wins there (measured on the TPU; kept for parity)
    return "segment_sum" if fa.max_occ > 32 else "gather"


class StepConstants(NamedTuple):
    """A step's numbers as 0-dim tensors of the state's dtype on its device:
    the clamp bounds of xs, xl and v, the fixed dt, the tolerance and the
    adaptive dt's bounds."""

    xs_lo: torch.Tensor
    xs_hi: torch.Tensor
    xl_lo: torch.Tensor
    xl_hi: torch.Tensor
    v_lo: torch.Tensor
    v_hi: torch.Tensor
    dt_fixed: torch.Tensor
    tol: torch.Tensor
    dt_min: torch.Tensor
    dt_max: torch.Tensor


def make_step_fn(fa: FormulaArrays, zeta: float, ode: ODEConfig, clause_group=None,
                 traj_group=None, device=None, clause_route: str = "b7",
                 traj_route: str = "b7"):
    """Build ``step(state, dev) -> state`` for a batched ODEState, using
    the torch twin of the RHS on the state's device.

    ``clause_group`` (a ``torch.distributed`` group): the state holds one
    clause segment of a clause mesh and ``dev`` that segment's formula
    tensors; the partial dv, with the negated sat flag in a last column, is
    summed, and the adaptive error max-reduced, over the group (JAX
    :246-274, :324-335): a call each of B7's standalone call, in place
    (``parallel/dist.mesh_reduce``: its kernel on a card, its plain version
    on the CPU), in the same order on every rank. ``traj_group``: the ranks
    whose rows share a batch-wide dt (``dt_mode="shared"``); its
    one-element error max reduces over them too, after the clause calls.
    ``clause_route`` and ``traj_route`` ("b7", or "dist" for
    ``torch.distributed``) are decided when the runner is built
    (``parallel/sharded.twin_routes``): a trajectory group over hosts takes
    "dist", whose CUDA IPC pages cannot cross a host.

    ``device``: where the step's constants (:class:`StepConstants`), B10's
    tables (``pallas``) and ``segment_sum``'s table (CUDA) are built, once. A
    step on a state there then creates no tensor from a Python number,
    reads nothing back to the host and branches on no tensor, which is what
    capturing it into a CUDA graph needs (``ops/scan_chunk.py``); a state on
    another device has them built at its first step. A mesh's step on B7
    keeps to that too (its calls wait for the peers in the stream), and is
    captured the same way (``parallel/sharded.make_sharded_chunk_runner``):
    ``step.calls(state)`` lists the B7 calls one step from ``state`` makes,
    ``(group, shape, dtype)`` in order (a capture begins their buffers
    first and rebases their flags at every replay, ``ops/butterfly.py``),
    and ``step.prepare(state, dev)`` builds ahead what a step would build at
    its first call (a clause shard's ``segment_sum`` table, read from
    ``dev``)."""
    from odesat_tpu_torch.ops.fused_chunk import cuda_device
    from odesat_tpu_torch.parallel import dist as pdist

    xl_cap = XL_CAP_PER_CLAUSE * fa.n_clauses  # real clause count (src/system.rs:95)
    zeta = float(zeta)
    dv_strategy = ode.dv_strategy
    if dv_strategy in ("fused", "stream", "auto"):
        # 'fused'/'stream' are whole-chunk kernels (make_chunk_runner
        # handles them); a single step picks between the scan accumulators
        dv_strategy = _scan_strategy(fa)
    if clause_group is not None and dv_strategy in ("gather", "pallas"):
        # the occurrence tables index the global clause slots; a clause
        # shard holds only its segment, so it sums by segment and reduces
        dv_strategy = "segment_sum"
    if clause_group is not None and len(fa.bucket_slices) > 1:
        raise ValueError(
            "width-bucketed formulas need the clause-shard kernel (ops/shard_stream.py); "
            "the scan fallback requires bucket=False on a clause mesh"
        )
    buckets = fa.bucket_slices if len(fa.bucket_slices) > 1 else None
    fixed_dt = float(ode.step_size) if ode.step_size is not None else 0.0
    consts = {}

    def constants(device, dtype) -> StepConstants:
        k = consts.get((device, dtype))
        if k is None:
            values = (EPSILON, 1.0 - EPSILON, 1.0, xl_cap, -1.0, 1.0, fixed_dt,
                      float(ode.tolerance), DT_MIN, DT_MAX)
            k = consts[device, dtype] = StepConstants(
                *(torch.tensor(c, dtype=dtype, device=device) for c in values))
        return k

    tables = {}

    def table(device, dev=None):
        # segment_sum's tables on CUDA (the CPU sums with index_add_): the
        # compiled formula's flat slots in bucket order, or a clause
        # shard's own segment (read once from ``dev``)
        t = tables.get(device)
        if t is None:
            if clause_group is None:
                ids = np.concatenate([fa.lit_var[:Kb, m0:m1].reshape(-1) for m0, m1, Kb in
                                      buckets or ((0, fa.n_clauses_padded, fa.lit_var.shape[0]),)])
            else:
                ids = dev.lit_var.reshape(-1).cpu().numpy()
            t = tables[device] = rhs_ops.segment_table(ids, fa.n_vars_padded, device)
        return t

    if device is not None:
        device = cuda_device(device)
        constants(device, state_dtype(ode))
        if dv_strategy == "segment_sum" and clause_group is None and device.type == "cuda":
            table(device)

    rhs_kernel = None
    if dv_strategy == "pallas":
        from odesat_tpu_torch.ops.rhs_kernel import make_rhs_kernel

        rhs_kernel = make_rhs_kernel(fa, zeta, ode.rigidity, ode.dtype, device=device)

    def derivs(v, xs, xl, dev: FormulaDevice):
        if rhs_kernel is not None:
            return rhs_kernel(v, xs, xl, dev)
        dv, dxs, dxl, allsat = rhs_ops.compute_derivatives(
            v, xs, xl,
            lit_var=dev.lit_var, sign=dev.sign, lit_mask=dev.lit_mask,
            clause_mask=dev.clause_mask, var_occ=dev.var_occ, occ_mask=dev.occ_mask,
            zeta=zeta, rigidity=ode.rigidity, dv_strategy=dv_strategy,
            bucket_slices=buckets,
            segment_table=(table(v.device, dev) if dv_strategy == "segment_sum" and v.is_cuda
                           else None),
        )
        if clause_group is not None:
            buf = pdist.mesh_reduce(torch.cat([dv, (~allsat).to(dv.dtype).unsqueeze(-1)], dim=-1),
                                    clause_group, "sum", clause_route)
            dv, allsat = buf[..., :-1], buf[..., -1] == 0
        return dv, dxs, dxl, allsat

    def update(v, xs, xl, dv, dxs, dxl, dt, k: StepConstants):
        """Clamped Euler update (reference: src/system.rs:93-97); dt is
        (B,). fmax/fmin ignore NaN like Rust's f64::max/min, so a NaN
        update (conflicting unit clauses summing +inf and -inf) clamps to
        the lower bound instead of poisoning the state."""
        dt_c = dt.unsqueeze(-1)

        def clamp(x, lo, hi):
            return torch.fmin(torch.fmax(x, lo), hi)

        xs2 = clamp(xs + dt_c * dxs, k.xs_lo, k.xs_hi)
        xl2 = clamp(xl + dt_c * dxl, k.xl_lo, k.xl_hi)
        v2 = clamp(v + dt_c * dv, k.v_lo, k.v_hi)
        return v2, xs2, xl2

    def freeze(cond, new, old):
        return torch.where(cond.unsqueeze(-1), new, old)

    def calls(state) -> list:
        # a step's B7 calls, in its order: the dv/sat sum of each RHS, the
        # adaptive error's max over the clause group, then the shared dt's
        # over the trajectory group
        out = []
        if clause_group is not None and clause_route == "b7":
            buf = (clause_group, (*state.v.shape[:-1], state.v.shape[-1] + 1), state.v.dtype)
            out += [buf] if ode.step_size is not None else [
                buf, buf, (clause_group, tuple(state.v.shape[:-1]), state.v.dtype)]
        if (ode.step_size is None and ode.dt_mode == "shared" and traj_group is not None
                and traj_route == "b7"):
            out.append((traj_group, (1,), state.v.dtype))
        return out

    def prepare(state, dev):
        constants(state.v.device, state.v.dtype)
        if dv_strategy == "segment_sum" and state.v.is_cuda:
            table(state.v.device, dev)

    def _declared(step):
        step.calls, step.prepare = calls, prepare
        return step

    if ode.step_size is not None:

        def step(state: ODEState, dev: FormulaDevice) -> ODEState:
            k = constants(state.v.device, state.v.dtype)
            dv, dxs, dxl, allsat = derivs(state.v, state.xs, state.xl, dev)
            dt_b = torch.where(state.done, 0.0, k.dt_fixed)
            v, xs, xl = update(state.v, state.xs, state.xl, dv, dxs, dxl, dt_b, k)
            return ODEState(v, xs, xl, state.dt, state.done | allsat)

        return _declared(step)

    def step(state: ODEState, dev: FormulaDevice) -> ODEState:
        k = constants(state.v.device, state.v.dtype)
        dv, dxs, dxl, allsat = derivs(state.v, state.xs, state.xl, dev)
        advance = ~state.done & ~allsat  # src/system.rs:122: no update when allsat
        dt = state.dt

        # one full step (trial) vs two half steps (kept)
        fv, fxs, fxl = update(state.v, state.xs, state.xl, dv, dxs, dxl, dt, k)
        hv, hxs, hxl = update(state.v, state.xs, state.xl, dv, dxs, dxl, 0.5 * dt, k)
        dv2, dxs2, dxl2, _ = derivs(hv, hxs, hxl, dev)
        tv, txs, txl = update(hv, hxs, hxl, dv2, dxs2, dxl2, 0.5 * dt, k)

        err = torch.maximum(
            (fv - tv).abs().amax(dim=-1),
            torch.maximum((fxs - txs).abs().amax(dim=-1), (fxl - txl).abs().amax(dim=-1)),
        )
        if clause_group is not None:
            err = pdist.mesh_reduce(err, clause_group, "max", clause_route)
        if ode.dt_mode == "shared":
            # reference inter parity: one dt for the whole batch, adapted
            # from the batch-max error of the trajectories that advance
            # (src/system.rs:122-136,314)
            err = torch.where(advance, err, 0.0).amax().reshape(1)
            if traj_group is not None:
                err = pdist.mesh_reduce(err, traj_group, "max", traj_route)
            err = err.expand(advance.shape)
        # err == 0 -> dt hits the ceiling, like the reference's dt*inf
        # clamped at 1e3 (src/system.rs:132-135)
        # a tensor numerator: `float / tensor` is reciprocal-then-multiply
        # in torch, which rounds twice where jnp divides once
        ratio = k.tol / err.clamp_min(1e-30)
        new_dt = torch.clamp(dt * torch.sqrt(ratio), k.dt_min, k.dt_max)

        v = freeze(advance, tv, state.v)
        xs = freeze(advance, txs, state.xs)
        xl = freeze(advance, txl, state.xl)
        dt = torch.where(advance, new_dt, state.dt)
        return ODEState(v, xs, xl, dt, state.done | allsat)

    return _declared(step)


def resolve_strategy(fa: FormulaArrays, ode: ODEConfig, device) -> str:
    """The port's ``auto`` ladder. When the state lives on CUDA, the dtype
    is float32 and the adaptive dt is not batch-shared: ``fused`` (the
    resident chunk kernel B1) if the formula passes its gate, else
    ``stream`` (the large-formula chunk kernel B2) if it passes that one.
    Otherwise the twin's ``segment_sum`` or ``gather`` on the state's
    device. The JAX ladder is the same with a TPU-backend gate
    (models/ode.py:375-401)."""
    if ode.dv_strategy != "auto":
        return ode.dv_strategy
    from odesat_tpu_torch.ops.fused_chunk import fused_supported
    from odesat_tpu_torch.ops.stream_chunk import stream_supported

    shared_adaptive = ode.dt_mode == "shared" and ode.step_size is None
    fixed = ode.step_size is not None
    if torch.device(device).type == "cuda" and ode.dtype == "float32" and not shared_adaptive:
        if fused_supported(fa, fixed):
            return "fused"
        if stream_supported(fa, fixed):
            return "stream"
    return _scan_strategy(fa)


def make_chunk_runner(
    fa: FormulaArrays, zeta: float, ode: ODEConfig, chunk_steps: int, device,
    donate: bool = True,
):
    """``run(state, dev) -> state`` advancing every trajectory by
    ``chunk_steps`` steps (solved trajectories stay frozen). The call
    consumes its input, as JAX's donated one (JAX :350-356): on the card it
    runs in place, and a caller that needs the entry state afterwards copies
    it first (``models/loop.copy_state``) or builds the runner with
    ``donate=False`` (JAX's ``donate=False``), which leaves its input.

    ``dv_strategy='fused'`` runs the whole chunk as one launch of the
    resident CUDA kernel B1 (ops/fused_chunk.py), ``'stream'`` as one launch
    of the large-formula kernel B2 (ops/stream_chunk.py); each raises for
    what its kernel cannot take, as the JAX package does. ``'auto'``
    resolves through :func:`resolve_strategy`. The scan strategies
    (``'gather'``, ``'segment_sum'``, and ``'pallas'``, whose RHS is B10 on
    CUDA) run ``chunk_steps`` single steps as the scan chunk
    (``ops/scan_chunk.py``): one CUDA graph replay on a CUDA state, the
    plain loop of steps on a CPU one."""
    shared_adaptive = ode.dt_mode == "shared" and ode.step_size is None
    if shared_adaptive and ode.dv_strategy in ("fused", "stream"):
        raise ValueError(
            "dt_mode='shared' is not supported by the chunk kernels; "
            "use dv_strategy='auto' (scan path) or per-trajectory dt"
        )
    strategy = resolve_strategy(fa, ode, device)
    if strategy == "fused":
        from odesat_tpu_torch.ops.fused_chunk import make_fused_chunk

        return make_fused_chunk(fa, zeta, ode, chunk_steps, device, donate)
    if strategy == "stream":
        from odesat_tpu_torch.ops.stream_chunk import make_stream_chunk

        return make_stream_chunk(fa, zeta, ode, chunk_steps, device, donate)

    from odesat_tpu_torch.ops.scan_chunk import make_scan_chunk

    step = make_step_fn(fa, zeta, dataclasses.replace(ode, dv_strategy=strategy), device=device)
    return make_scan_chunk(step, chunk_steps, device, donate)


def make_multi_chunk_runner(
    fa: FormulaArrays,
    zeta: float,
    ode: ODEConfig,
    chunk_steps: int,
    max_chunks: int,
    device,
    stop_on: str = "any",
    chunk=None,
):
    """``run(state, dev) -> (state, steps_advanced)`` running up to
    ``max_chunks`` chunks of ``chunk_steps``, testing before each chunk
    whether any (``stop_on="any"``) or every (``"all"``) trajectory is
    done, with an exact ``steps_advanced`` (JAX :443-538). A kernel runner
    (B1 or B2) or the scan chunk (``ops/scan_chunk.py``) on a CUDA state
    runs the whole dispatch as one graph launch that stops on the card
    (``ops/device_loop.py``), as JAX runs its chunk inside one
    ``lax.while_loop``; any runner on the CPU, and a runner of another kind,
    runs the host loop of ``models/loop.run_chunks``, the device loop's
    plain version (a mesh's dispatch: ``parallel/sharded.
    make_sharded_multi_runner``). ``chunk`` reuses an already built chunk
    runner. A dispatch consumes its input, as JAX's (``donate_argnums=0``,
    JAX :481, :538)."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.ops import device_loop

    if chunk is None:
        chunk = make_chunk_runner(fa, zeta, ode, chunk_steps, device)
    stop_all = stop_on == "all"
    on_card = isinstance(chunk, device_loop.KernelChunk)

    def run(state: ODEState, dev=None):
        if on_card and state.v.device.type == "cuda":
            return device_loop.run(chunk, state, max_chunks, stop_all=stop_all, dev=dev)
        return run_chunks(lambda st: chunk(st, dev), chunk_steps, max_chunks,
                          stop_all=stop_all)(state)

    return run


def compile_for_config(formula_or_arrays, config: SolverConfig) -> FormulaArrays:
    """The formula's arrays as the config lays them out (arrays pass
    through): width buckets when ``config.bucket`` is "on", or "auto" on
    a formula of at least 512 clauses of mixed widths."""
    if isinstance(formula_or_arrays, FormulaArrays):
        return formula_or_arrays
    formula = formula_or_arrays
    bucket = config.bucket == "on" or (
        config.bucket == "auto"
        and formula.num_clauses >= 512
        and len(set(map(len, formula.clauses))) > 1
    )
    return compile_formula(
        formula,
        clause_pad=config.clause_pad,
        var_pad=config.var_pad,
        bucket=bucket,
        window_sort=config.window_sort,
    )


def seeded_generator(config: SolverConfig, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``config.seed`` (from
    the OS when it is None)."""
    seed = config.seed if config.seed is not None else int.from_bytes(os.urandom(4), "little")
    return torch.Generator(device=device).manual_seed(seed)


def check_mesh_shape(rows: int, fa: FormulaArrays, mesh) -> None:
    """Raise unless ``rows`` trajectories and the padded clause axis divide
    across the mesh."""
    if rows % mesh.n_traj or fa.n_clauses_padded % mesh.n_clause:
        raise ValueError(
            f"batch_size={rows} and {fa.n_clauses_padded} padded clauses must divide across "
            f"a {mesh.n_traj}x{mesh.n_clause} mesh"
        )


def simulate_batch(
    formula_or_arrays,
    config: SolverConfig,
    *,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    v0: Optional[np.ndarray] = None,
    stop_on: str = "any",
    harvest=None,
    mesh=None,
) -> SolveResult:
    """Run ``config.batch_size`` trajectories on ``device`` to completion
    or budget. ``device`` is the card unless the caller asks for the CPU
    (``"cpu"``); without a card ``"cuda"`` raises (``utils/device.py``).

    ``stop_on``: "any" stops as soon as one trajectory reaches allsat
    (reference inter semantics, src/system.rs:291); "all" runs until every
    trajectory is done or the budget is exhausted. ``harvest(state, done)``
    is called between chunks with the host-pulled done flags; a return
    value other than None or False stops the run and comes back in
    ``SolveResult.harvested`` (on a mesh, rank 0's is the parent's). ``generator`` (a ``torch.Generator`` on
    ``device``) draws the initial state; by default one is seeded from
    ``config.seed``.

    ``mesh`` (``parallel/mesh.Mesh``): call on every rank of the world. A
    formula is compiled for the mesh (``parallel/sharded.compile_for_mesh``);
    every rank draws the global initial state and keeps its rows and clause
    segment; the result holds the global batch on every rank.

    ``config.resume_from`` continues a snapshot (``utils/checkpoint.py``,
    the JAX package's format): its state replaces the initial draw, its
    step count counts against the budget, and its mesh layout must have
    this run's clause width (the trajectory width may differ, JAX
    :601-616). ``config.checkpoint_path`` with ``checkpoint_every_chunks``
    writes snapshots (rank 0 on a mesh, after every rank's gather).

    ``config.profile_dir`` traces the whole call (``models/loop.profiled``).
    Under a profiler each stage of the call is a span (``utils/logging.
    span``): ``ode.solve`` around it, and inside ``ode.compile``,
    ``ode.state``, ``ode.build`` (a runner built), the device loop's
    ``device_loop.capture`` and ``device_loop.dispatch``, ``loop.decide``
    (``models/loop.drive_chunks``), ``ode.readout`` and ``ode.release``.
    """
    from odesat_tpu_torch.models.loop import profiled

    with profiled(config.profile_dir), span("ode.solve"):
        return _simulate_batch(formula_or_arrays, config, device, generator, v0, stop_on,
                               harvest, mesh)


def _simulate_batch(formula_or_arrays, config, device, generator, v0, stop_on, harvest, mesh):
    global readout_bytes
    from odesat_tpu_torch.utils.device import entry_device

    device = entry_device(device)
    n_clause = 1 if mesh is None else mesh.n_clause
    with span("ode.compile"):
        if mesh is not None and not isinstance(formula_or_arrays, FormulaArrays):
            from odesat_tpu_torch.parallel.sharded import compile_for_mesh

            fa = compile_for_mesh(formula_or_arrays, config, mesh)
        else:
            fa = compile_for_config(formula_or_arrays, config)
        ode = config.ode
        if n_clause == 1:
            strategy = resolve_strategy(fa, ode, device)
            if ode.dv_strategy == "auto":
                logger.info("dv_strategy auto -> %s on %s", strategy, device)
            ode = dataclasses.replace(ode, dv_strategy=strategy)
        zeta = ode.resolve_zeta(fa.density)
    steps_resumed = 0
    with span("ode.state"):
        if config.resume_from:
            from odesat_tpu_torch.interop import state_from_numpy
            from odesat_tpu_torch.utils.checkpoint import load_state, validate_mesh_layout

            loaded, steps_resumed, saved_layout = load_state(config.resume_from, ODEState)
            # the clause axis changes the compiled clause layout; the traj axis
            # is data parallelism for the ODE state and may reshard
            validate_mesh_layout(saved_layout, mesh, what="ODE snapshot", traj_sensitive=False)
            state = state_from_numpy(*loaded, device=device)
        else:
            if generator is None:
                if mesh is not None and config.seed is None:
                    raise ValueError("a mesh run needs a seed: every rank draws the same "
                                     "initial state")
                generator = seeded_generator(config, device)
            state = init_state(fa, config.batch_size, generator, ode, device, v0=v0)
        dev = formula_device(fa, device, dtype=state_dtype(ode))
        sync = None
        if mesh is not None:
            from odesat_tpu_torch.parallel.dist import MeshSync
            from odesat_tpu_torch.parallel.sharded import shard_inputs

            check_mesh_shape(state.v.shape[0], fa, mesh)
            state, dev = shard_inputs(state, dev, mesh)
            sync = MeshSync(mesh, device)

    from odesat_tpu_torch.models.loop import device_dispatch_plan, drive_chunks

    inner = config.chunk_steps
    chunk_steps = inner
    dispatch_ok, dispatch_steps = device_dispatch_plan(config, ode.steps)
    use_multi = harvest is None and dispatch_ok

    # chunk runners by length, bounded: a solve needs its inner chunk, a
    # few tail lengths and the grown chunks
    @functools.lru_cache(maxsize=8)
    def chunk_runner(n):
        with span("ode.build"):
            if mesh is None:
                return make_chunk_runner(fa, zeta, ode, n, device)
            from odesat_tpu_torch.parallel.sharded import make_sharded_chunk_runner

            return make_sharded_chunk_runner(fa, zeta, ode, n, mesh, device)

    def make_runner(n):
        r = chunk_runner(min(n, inner) if use_multi else n)
        if not use_multi or n <= inner:
            return lambda st: r(st, dev)
        with span("ode.build"):
            if mesh is None:
                m = make_multi_chunk_runner(fa, zeta, ode, inner, n // inner, device,
                                            stop_on=stop_on, chunk=r)
                return lambda st: m(st, dev)
            from odesat_tpu_torch.parallel.sharded import make_sharded_multi_runner

            return make_sharded_multi_runner(r, inner, n // inner, mesh, device, stop_on, dev)

    if use_multi:
        chunk_steps = dispatch_steps  # nominal slice between host decisions

    harvested = []

    def should_stop(st, done):
        # harvest first: the oracle-verified exit must run even on the
        # chunk where every trajectory converges
        if harvest is not None:
            view = st
            if sync is not None and done.any():  # the global rows, on every rank
                view = st._replace(v=torch.as_tensor(fetch(st.v, mesh)))
            got = harvest(view, done)
            if got is not None and got is not False:
                harvested.append(got)
                return True
        if stop_on == "any" and done.any():
            return True
        return bool(done.all())

    from odesat_tpu_torch.utils.checkpoint import mesh_layout_of, save_state

    state, steps_run, wall_time = drive_chunks(
        state,
        make_runner,
        config,
        budget=ode.steps,  # None => unbounded
        should_stop=should_stop,
        steps_resumed=steps_resumed,
        chunk_steps=chunk_steps,
        sync=sync,
        save=lambda st, n: save_state(config.checkpoint_path, st, n,
                                      mesh_layout=mesh_layout_of(mesh), mesh=mesh),
    )

    with span("ode.readout"):
        if mesh is not None:
            from odesat_tpu_torch.parallel.sharded import check_replicated

            check_replicated(state.v, mesh)
        done = fetch(state.done, mesh)
        solved = np.flatnonzero(done)
        result = SolveResult(
            assignment=fetch(state.v[:, : fa.n_vars] > 0.0, mesh),
            done=done,
            steps=steps_run,
            solved_index=int(solved[0]) if solved.size else None,
            wall_time_s=wall_time,
            harvested=harvested[0] if harvested else None,
        )
        readout_bytes += result.assignment.nbytes + done.nbytes
    # the solve's runners go here, and with them the device loop's graph,
    # not at some later collection: nothing else holds them
    with span("ode.release"):
        chunk_runner.cache_clear()
    return result


def simulate(
    formula: CNFFormula,
    config: Optional[SolverConfig] = None,
    *,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    v0: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Single-trajectory solve returning the boolean readout of length
    ``varnum`` (reference: src/system.rs:156-239). The formula must be
    normalized (dense variable indices)."""
    config = config or SolverConfig()
    if config.batch_size != 1:
        config = dataclasses.replace(config, batch_size=1)
    result = simulate_batch(formula, config, device=device, generator=generator, v0=v0)
    return result.assignment[0]
