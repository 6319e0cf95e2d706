"""Stochastic discrete engine in PyTorch: clause-weighted randomized local
search.

The port of ``odesat_tpu.models.stoch`` (reference: src/stoch.rs:1-110),
with the same state and step. Per step:

* every clause is evaluated against the boolean assignment;
* clause weights update: satisfied -> max(xl-1, 1), unsatisfied ->
  min(xl+20, 2**24);
* every variable sums ``total = sum xl`` over the clauses holding it and
  ``unsat = sum xl`` over the unsatisfied ones, from the post-update
  weights;
* each variable flips with probability ``unsat/total``; done chains stay
  frozen, and a chain is done once every clause holds.

On CUDA a chunk of steps is one launch of a hand-written kernel
(ops/stoch_chunk.py): B3 with the formula resident in shared memory, else
B4 with it in L2, else (past both gates, logged) the torch scan twin of
:func:`make_stoch_step`. On the CPU ``auto`` runs the twin, as the JAX
package does off the TPU; ``fused="on"`` runs the kernels' plain version.

Randomness is explicit: one CPU ``torch.Generator`` seeded from
``config.seed`` draws a 31-bit seed for every kernel launch on the host
(no device round trip) and the seed of the twin's device generator, from
which the twin draws its uniforms. Kernels and twin therefore draw
different flip streams for one seed, as in the JAX package.

On a mesh (``parallel/``) the chains split over the ``traj`` axis, each
row with its own generator; a ``clause`` axis splits the clauses, and each
step's weight sums are all-reduced over the clause group before the flips
are drawn: in the next launch of B9 (ops/stoch_chunk.py, the default), or
in torch after B8 or the twin's evaluation (:func:`make_stoch_clause_step`).

Checkpoints store, beside the state, the state of every generator the
runners draw from (:func:`generator_states`): the CPU generator, and the
scan twin's device generator, one row of each per trajectory row of the
mesh. A resumed run therefore flips as the uninterrupted run with the same
cadence does, bit for bit. A JAX stoch snapshot (its state carries a PRNG
key) is refused: the packages' random streams differ.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays, slot_clause_map
from odesat_tpu_torch.constants import STOCH_ALPHA
from odesat_tpu_torch.utils.config import SolverConfig
from odesat_tpu_torch.utils.logging import logger

XL_CAP = 2**24


class StochState(NamedTuple):
    """Chains, batched over the leading axis: v (B, Np) bool assignment,
    xl (B, Mp) int32 clause weights, done (B,) bool latches. The JAX
    state's PRNG key is the runner's generator here."""

    v: torch.Tensor
    xl: torch.Tensor
    done: torch.Tensor


@dataclass
class StochResult:
    assignment: np.ndarray  # (B, n_vars) bool
    done: np.ndarray  # (B,)
    steps: int
    solved_index: Optional[int]
    wall_time_s: float = 0.0

    def best_assignment(self) -> np.ndarray:
        idx = self.solved_index if self.solved_index is not None else 0
        return self.assignment[idx]


def init_stoch_state(fa: FormulaArrays, batch_size: int, device) -> StochState:
    """All-false start, unit weights (reference: src/stoch.rs:84-87)."""
    return StochState(
        v=torch.zeros((batch_size, fa.n_vars_padded), dtype=torch.bool, device=device),
        xl=torch.ones((batch_size, fa.n_clauses_padded), dtype=torch.int32, device=device),
        done=torch.zeros((batch_size,), dtype=torch.bool, device=device),
    )


def make_stoch_step(fa: FormulaArrays, device):
    """The scan twin's step ``step(state, u) -> state`` with the uniforms
    ``u`` (B, Np) f32 given, so that tests can inject the JAX package's
    draws. The weight gather composes ``var_occ`` with the slot-to-clause
    map, so it is right for bucketed layouts too (JAX :74-120)."""

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    lit_var = put(fa.lit_var, torch.int64)  # (K, M)
    pos = put(fa.sign > 0, torch.bool)
    lit_mask = put(fa.lit_mask > 0, torch.bool)
    clause_mask = put(fa.clause_mask > 0, torch.bool)  # (M,)
    occ_clause = put(slot_clause_map(fa)[fa.var_occ], torch.int64)  # (N, D)
    occ_mask = put(fa.occ_mask > 0, torch.float32)
    has_occ = put(fa.occ_mask.sum(axis=-1) > 0, torch.bool)

    def step(state: StochState, u: torch.Tensor) -> StochState:
        lit_true = state.v[:, lit_var] == pos  # (B, K, M)
        sat = (lit_true & lit_mask).any(dim=-2)  # (B, M)
        xl = torch.where(sat, (state.xl - 1).clamp_min(1),
                         (state.xl + STOCH_ALPHA).clamp_max(XL_CAP))
        xl = torch.where(clause_mask, xl, 0)
        xl_f = xl.to(torch.float32)
        unsat_f = xl_f * (~sat)
        total = (xl_f[:, occ_clause] * occ_mask).sum(dim=-1)  # (B, N)
        unsat_w = (unsat_f[:, occ_clause] * occ_mask).sum(dim=-1)
        flip = (u * total < unsat_w) & has_occ
        active = ~state.done
        all_sat = (sat | ~clause_mask).all(dim=-1)
        v = torch.where(active.unsqueeze(1) & flip, ~state.v, state.v)
        xl = torch.where(active.unsqueeze(1), xl, state.xl)
        return StochState(v, xl, state.done | all_sat)

    return step


def make_stoch_clause_eval(fa: FormulaArrays, device, shard: int = 0, n_shards: int = 1):
    """The twin's evaluation over clause segment ``shard`` of ``n_shards``,
    with B8's interface: ``ev(v, xl, active) -> (total, unsat, xl_new,
    sat)``, the weight sums by index_add over the segment's literal slots
    (JAX make_stoch_clause_step :139-170). Masked slots add nothing, so any
    layout works. ``ev.packed(v, xl, done) -> (xl_new, acc)`` is the same on
    rows, with acc = (total | unsat | 1 - sat), what
    :func:`make_stoch_clause_step` takes."""
    from odesat_tpu_torch.ops.shard_stream import shard_slice

    seg = shard_slice(fa.n_clauses_padded, n_shards, shard)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a[..., seg])).to(device=device, dtype=dtype)

    lit_var = put(fa.lit_var, torch.int64)  # (K, M_local)
    pos = put(fa.sign > 0, torch.bool)
    lit_mask = put(fa.lit_mask > 0, torch.bool)
    clause_mask = put(fa.clause_mask > 0, torch.bool)
    ids = lit_var.reshape(-1)
    Np = fa.n_vars_padded

    def ev(v, xl, active):
        B = v.shape[0]
        sat = ((v[:, lit_var] == pos) & lit_mask).any(dim=-2)  # (B, M_local)
        xl_new = torch.where(sat, (xl - 1).clamp_min(1), (xl + STOCH_ALPHA).clamp_max(XL_CAP))
        xl_new = torch.where(clause_mask, xl_new, 0)
        w = xl_new.to(torch.float32).unsqueeze(1) * lit_mask  # (B, K, M_local)
        u = (xl_new.to(torch.float32) * ~sat).unsqueeze(1) * lit_mask
        total = w.new_zeros(B, Np).index_add_(1, ids, w.reshape(B, -1))
        unsat = w.new_zeros(B, Np).index_add_(1, ids, u.reshape(B, -1))
        allsat = (sat | ~clause_mask).all(dim=-1)
        return total, unsat, torch.where(active.unsqueeze(1), xl_new, xl), allsat

    def packed(v, xl, done):
        total, unsat, xl, allsat = ev(v, xl, ~done)
        return xl, torch.cat([total, unsat, (~allsat).to(total.dtype).unsqueeze(1)], dim=1)

    ev.packed = packed
    return ev


def make_stoch_clause_step(ev, clause_group=None):
    """The clause-mesh stoch step ``step(state, u) -> state`` (JAX
    :123-180) on a state of rows (B, X) or of tiles (G, X, R)
    (``ops/tiles.py``), with the uniforms ``u`` in the same layout. ``ev(v,
    xl, done) -> (xl_new, acc)`` evaluates this rank's clause segment in
    that layout (B8's ``make_stoch_shard_eval(...).tiled`` or the twin's
    :func:`make_stoch_clause_eval` ``.packed``), acc = (total | unsat | 1 -
    sat); acc is summed over ``clause_group`` as it is, in place, by B7's
    standalone call (``ops/butterfly.py``: its kernel for CUDA tensors, its
    plain version for CPU tensors), then every rank of the group draws the
    same flips from the same uniforms. The sums are integers in f32, so the
    partition cannot change a flip below 2**24."""
    from odesat_tpu_torch.ops import butterfly as bf

    def step(state: StochState, u: torch.Tensor) -> StochState:
        xl, acc = ev(state.v, state.xl, state.done)
        if clause_group is not None:
            bf.butterfly(acc, clause_group, None, acc)
        Np = u.shape[1]
        # total == 0 for a variable in no clause: 0 < 0 never flips
        flip = u * acc[:, :Np] < acc[:, Np:2 * Np]
        v = torch.where((~state.done).unsqueeze(1) & flip, ~state.v, state.v)
        return StochState(v, xl, state.done | (acc[:, 2 * Np] == 0))

    return step


def stoch_core_supported(fa: FormulaArrays, device, fused: str = "auto") -> bool:
    """Build-free check that :func:`make_stoch_chunk_runner` would take a
    kernel (B3 or B4) over the scan twin."""
    from odesat_tpu_torch.ops.stoch_chunk import stoch_fused_supported, stoch_stream_supported

    if fused == "off" or (fused == "auto" and torch.device(device).type != "cuda"):
        return False
    return stoch_fused_supported(fa) or stoch_stream_supported(fa)


def resolve_kernel(fa: FormulaArrays, device, fused: str = "auto") -> str:
    """The ``fused`` ladder: "fused" (B3) when its gate takes the formula,
    else "stream" (B4), else "scan" (the twin). ``auto`` takes a kernel
    only for CUDA states, like the JAX ladder on the TPU backend
    (JAX :203-235); ``on`` raises when neither gate takes the formula;
    ``off`` is the twin."""
    from odesat_tpu_torch.ops.stoch_chunk import stoch_fused_supported, stoch_stream_supported

    if fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be 'auto', 'on' or 'off', not {fused!r}")
    if stoch_core_supported(fa, device, fused):
        return "fused" if stoch_fused_supported(fa) else "stream"
    if fused == "on":
        raise ValueError(
            "fused='on' but neither stoch kernel takes this formula (its chain state "
            "is past the shared-memory gate); use fused='auto' or 'off'"
        )
    return "scan"


def make_stoch_chunk_runner(
    fa: FormulaArrays,
    chunk_steps: int,
    device,
    generator: torch.Generator,
    fused: str = "auto",
    matmul_dtype: str = "float32",
):
    """``run(state) -> state`` advancing every chain ``chunk_steps`` steps.

    Kernels (B3 or B4, :func:`resolve_kernel`) take one 31-bit seed per
    launch from ``generator``, a CPU ``torch.Generator``. The scan twin
    draws its uniforms from a device generator seeded once from
    ``generator``. ``matmul_dtype="bfloat16"`` rounds each weight to bf16
    in the kernels (the twin, like the JAX scan path, sums in f32)."""
    kind = resolve_kernel(fa, device, fused)
    if kind != "scan":
        from odesat_tpu_torch.ops.stoch_chunk import make_stoch_chunk

        fn = make_stoch_chunk(fa, chunk_steps, kind, matmul_dtype, device)

        def run_kernel(state: StochState) -> StochState:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
            return fn(state, seed)

        return run_kernel

    step = make_stoch_step(fa, device)
    dev_gen = torch.Generator(device=device)
    dev_gen.manual_seed(int(torch.randint(0, 2**63 - 1, (1,), generator=generator)))
    shape = (fa.n_vars_padded,)

    def run_scan(state: StochState) -> StochState:
        for _ in range(chunk_steps):
            u = torch.rand((state.v.shape[0], *shape), generator=dev_gen, device=device)
            state = step(state, u)
        return state

    run_scan.device_generator = dev_gen  # a checkpoint stores its state
    return run_scan


def generator_states(generator: torch.Generator, runner, mesh=None, device=None) -> dict:
    """The states of the generators a stoch run draws from, as NumPy uint8
    arrays with one row per trajectory row of the mesh (one row off a
    mesh): ``rng_cpu``, the CPU ``generator``'s, and ``rng_device``, the
    scan twin's device generator's where ``runner`` (the run's chunk runner
    of its inner length) has one. On a mesh a collective (every rank calls
    it; a row's clause ranks hold the same generator) over tensors on
    ``device``."""
    from odesat_tpu_torch.parallel.dist import fetch

    states = {"rng_cpu": generator.get_state()}
    dev_gen = getattr(runner, "device_generator", None)
    if dev_gen is not None:
        states["rng_device"] = dev_gen.get_state()
    out = {}
    for key, st in states.items():
        row = st.to(torch.int32).unsqueeze(0)
        out[key] = fetch(row if mesh is None else row.to(device), mesh).astype(np.uint8)
    return out


def restore_generators(extra: dict, generator: torch.Generator, runner, mesh=None,
                       what: str = "stoch snapshot") -> None:
    """Set ``generator`` (and ``runner``'s device generator, if it has one)
    to this rank's row of the states :func:`generator_states` saved."""
    n_rows = 1 if mesh is None else mesh.n_traj
    cpu = extra.get("rng_cpu")
    if cpu is None:
        raise ValueError(f"this {what} holds no generator states; resume it with the package "
                         "that wrote it")
    if cpu.shape[0] != n_rows:
        if mesh is None:
            raise ValueError(f"this {what} was taken on a mesh (per-row generator states); "
                             "resume with the same --devices count")
        raise ValueError(f"cannot resume this {what} on a {n_rows}-device mesh: it holds "
                         f"{cpu.shape[0]} per-row generator state(s); resume with the same "
                         "--devices count")
    row = 0 if mesh is None else mesh.traj_index
    generator.set_state(torch.from_numpy(np.ascontiguousarray(cpu[row])))
    dev_gen = getattr(runner, "device_generator", None)
    if dev_gen is None:
        return
    if "rng_device" not in extra:
        raise ValueError(f"this {what} holds no state of the scan twin's device generator; "
                         "it was taken on a run through the kernels")
    try:
        dev_gen.set_state(torch.from_numpy(np.ascontiguousarray(extra["rng_device"][row])))
    except RuntimeError as e:
        raise ValueError(f"this {what}'s device generator state does not fit this device's "
                         f"generator ({e}); resume it on the device type that wrote it") from None


def make_multi_stoch_runner(chunk, chunk_steps: int, max_chunks: int):
    """``run(state) -> (state, steps_advanced)`` running up to
    ``max_chunks`` chunks of the chunk runner ``chunk``, stopping after the
    first chunk that leaves any chain done: the host-loop twin of the JAX
    package's on-device loop (JAX :267-309), with the same early-exit
    window and an exact ``steps_advanced`` (``models/loop.run_chunks``,
    which the ODE engine's multi-chunk runner uses too)."""
    from odesat_tpu_torch.models.loop import run_chunks

    return run_chunks(chunk, chunk_steps, max_chunks)


def search(
    formula_or_arrays,
    config: Optional[SolverConfig] = None,
    *,
    device,
    generator: Optional[torch.Generator] = None,
    fused: str = "auto",
    mesh=None,
) -> StochResult:
    """Batched stochastic search (reference: src/stoch.rs:80-110 runs one
    chain; here ``config.batch_size`` chains run as a batch and the search
    stops after the chunk in which any chain satisfies every clause).

    Runs over the shared chunk driver (models/loop.drive_chunks): step and
    wall-clock budgets, chunk escalation and progress logs as in the ODE
    engine. ``generator`` is a CPU ``torch.Generator``; by default one is
    seeded from ``config.seed``. The formula is compiled with the ODE
    engine's width-bucket rule; the dynamics do not depend on the clause
    layout.

    ``mesh`` (``parallel/mesh.Mesh``, call on every rank): chains split over
    the traj axis, each row drawing from its own generator seeded with
    (seed, row) (``parallel/sharded.row_generator``); a clause axis runs
    the clause path (``parallel/sharded.make_sharded_stoch_runner``). The
    streams differ from the unsharded run's, as the JAX package's do.

    ``config.resume_from`` continues a port stoch snapshot: its chains, its
    step count and its generator states, on a mesh of its own layout (JAX
    :454-480); ``checkpoint_path`` with ``checkpoint_every_chunks`` writes
    them."""
    from odesat_tpu_torch.models.ode import check_mesh_shape, compile_for_config, seeded_generator
    from odesat_tpu_torch.parallel.dist import fetch

    config = config or SolverConfig()
    device = torch.device(device)
    if mesh is not None and not isinstance(formula_or_arrays, FormulaArrays):
        from odesat_tpu_torch.parallel.sharded import compile_for_mesh

        fa = compile_for_mesh(formula_or_arrays, config, mesh, engine="stoch")
    else:
        fa = compile_for_config(formula_or_arrays, config)
    matmul_dtype = config.ode.matmul_dtype
    sync = None
    if mesh is None:
        if generator is None:
            generator = seeded_generator(config, "cpu")
        kind = resolve_kernel(fa, device, fused)
        logger.info("stoch chunk runner %s -> %s on %s", fused, kind, device)
    else:
        from odesat_tpu_torch.parallel.dist import MeshSync
        from odesat_tpu_torch.parallel.sharded import row_generator

        check_mesh_shape(config.batch_size, fa, mesh)
        if generator is None:
            if config.seed is None:
                raise ValueError("a mesh run needs a seed: every rank of a row draws the same "
                                 "numbers")
            generator = row_generator(config.seed, mesh)
        sync = MeshSync(mesh, device)

    from odesat_tpu_torch.models.loop import device_dispatch_plan, drive_chunks

    inner = config.chunk_steps
    use_multi, dispatch_steps = device_dispatch_plan(config, config.ode.steps)

    # chunk runners by length, bounded: a search needs its inner chunk, a
    # few tail lengths and the grown chunks
    @functools.lru_cache(maxsize=8)
    def chunk_runner(n):
        if mesh is None:
            return make_stoch_chunk_runner(fa, n, device, generator, fused=fused,
                                           matmul_dtype=matmul_dtype)
        from odesat_tpu_torch.parallel.sharded import make_sharded_stoch_runner

        return make_sharded_stoch_runner(fa, n, mesh, device, generator, matmul_dtype, fused,
                                         config.ode.shard_chunk)

    def make_runner(n):
        if use_multi and n > inner:
            if mesh is None:
                return make_multi_stoch_runner(chunk_runner(inner), inner, n // inner)
            from odesat_tpu_torch.parallel.sharded import make_sharded_multi_runner

            return make_sharded_multi_runner(chunk_runner(inner), inner, n // inner, mesh, device)
        return chunk_runner(n)

    from odesat_tpu_torch.interop import stoch_state_from_numpy
    from odesat_tpu_torch.utils.checkpoint import (
        load_generator_states,
        load_state,
        mesh_layout_of,
        save_state,
        validate_mesh_layout,
    )

    steps_resumed = 0
    if config.resume_from:
        loaded, steps_resumed, saved_layout = load_state(config.resume_from, StochState)
        # the full layout: the clause axis orders the clauses, the traj axis
        # the per-row generators
        validate_mesh_layout(saved_layout, mesh, what="stoch snapshot")
        state = stoch_state_from_numpy(*loaded, device=device)
        # the inner runner draws its seeds when built; the snapshot's
        # generator states then replace what the draw left
        restore_generators(load_generator_states(config.resume_from), generator,
                           chunk_runner(inner), mesh)
    else:
        state = init_stoch_state(fa, config.batch_size, device)
    if mesh is not None:
        from odesat_tpu_torch.parallel.sharded import shard_stoch_inputs

        state = shard_stoch_inputs(state, mesh)

    def save(st, n):
        extra = generator_states(generator, chunk_runner(inner), mesh, device)
        save_state(config.checkpoint_path, st, n, mesh_layout=mesh_layout_of(mesh), mesh=mesh,
                   extra=extra)

    state, steps_run, wall_time = drive_chunks(
        state,
        make_runner,
        config,
        budget=config.ode.steps,
        should_stop=lambda st, done: bool(done.any()),
        steps_resumed=steps_resumed,
        chunk_steps=dispatch_steps if use_multi else None,
        sync=sync,
        save=save,
    )
    if mesh is not None:
        from odesat_tpu_torch.parallel.sharded import check_replicated

        check_replicated(state.v, mesh)
    done = fetch(state.done, mesh)
    solved = np.flatnonzero(done)
    return StochResult(
        assignment=fetch(state.v[:, : fa.n_vars], mesh),
        done=done,
        steps=steps_run,
        solved_index=int(solved[0]) if solved.size else None,
        wall_time_s=wall_time,
    )
