"""Hybrid portfolio: race the ODE and stochastic engines on one formula.

The port of ``odesat_tpu.models.hybrid``. No reference counterpart: the
reference picks one engine a run (``solve``/``inter`` or ``stoch``). The
engines have complementary strengths, and on a card both are chunked
launches, so interleaving them costs only the launches: run an ODE chunk,
then a stoch chunk, and stop as soon as either batch holds a row that
satisfies every clause. Each engine keeps its own batch and random stream;
the step budget counts for each engine on its own, and the chunk length
stays ``config.chunk_steps`` (the JAX loop never grows it).

The pairs of chunks run through the shared host loop
(``models/loop.drive_chunks``: budget and its tail chunks, wall clock,
``MeshSync`` on a mesh, the profiler), with the hybrid's order of side
effects: both engines logged and snapshotted before the done check, the
ODE engine's done checked first (a tie goes to ``"ode"``), then the stoch
engine's, then the wall clock.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays, compile_formula
from odesat_tpu_torch.models.ode import ODEState
from odesat_tpu_torch.models.stoch import StochState
from odesat_tpu_torch.utils.config import SolverConfig
from odesat_tpu_torch.utils.logging import logger

ENGINES = ("ode", "stoch")


class HybridState(NamedTuple):
    """Both engines' states. A NamedTuple, not a bare tuple: ``drive_chunks``
    reads a bare tuple as ``(state, steps_advanced)``."""

    ode: ODEState
    stoch: StochState

    @property
    def done(self) -> torch.Tensor:
        """(B, 2) bool: each ODE row's latch, then each stoch chain's."""
        return torch.stack([self.ode.done, self.stoch.done], dim=1)


@dataclass
class HybridResult:
    engine: str  # "ode" | "stoch" | "none"
    assignment: np.ndarray  # (n_vars,) bool: the winner's first satisfied row
    solved: bool
    steps: int  # steps run per engine
    wall_time_s: float = 0.0
    # seconds of each engine's chunks (CUDA events on a card, the host clock
    # on the CPU; this rank's on a mesh)
    engine_seconds: dict = field(default_factory=dict)


class EngineClock:
    """Seconds each engine's chunks took: CUDA events recorded around them on
    a card, read once a later done read has waited for them; the host clock
    on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pending = []
        self.seconds = dict.fromkeys(ENGINES, 0.0)

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def add(self, marks) -> None:
        self.pending.append(marks)

    def totals(self) -> dict:
        for a, b, c in self.pending:
            for name, (x, y) in zip(ENGINES, ((a, b), (b, c))):
                self.seconds[name] += x.elapsed_time(y) / 1e3 if self.cuda else y - x
        self.pending.clear()
        return dict(self.seconds)


def hybrid_arrays(formula_or_arrays, config: SolverConfig, mesh=None) -> FormulaArrays:
    """The layout both engines run on (JAX :64-79; arrays pass through):
    ``compile_formula`` with the config's padding and window sort and no
    width buckets, so the arrays equal the JAX hybrid's; on a mesh
    ``compile_for_mesh`` for the ODE engine."""
    if isinstance(formula_or_arrays, FormulaArrays):
        return formula_or_arrays
    if mesh is not None:
        from odesat_tpu_torch.parallel.sharded import compile_for_mesh

        return compile_for_mesh(formula_or_arrays, config, mesh, engine="ode")
    return compile_formula(formula_or_arrays, clause_pad=config.clause_pad,
                           var_pad=config.var_pad, window_sort=config.window_sort)


def hybrid_search(
    formula_or_arrays,
    config: Optional[SolverConfig] = None,
    *,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> HybridResult:
    """Interleave ODE and stochastic chunks on ``device`` (the card unless
    the caller asks for the CPU) until either
    engine's batch reaches allsat, the per-engine step budget runs out, or
    the wall-clock budget expires (JAX :42-285).

    The formula is compiled by :func:`hybrid_arrays`, both engines on that
    one layout. One CPU ``generator`` (by default seeded from
    ``config.seed``) gives two seeds: the ODE initial state's device
    generator and the stoch engine's generator (per trajectory row on a
    mesh, ``parallel/sharded.row_generator``), as JAX splits one key.

    ``mesh`` (``parallel/mesh.Mesh``, call on every rank): both batches
    split over the traj axis; a clause axis runs B6 and B9 (or their
    fall-backs) through ``make_sharded_chunk_runner`` and
    ``make_sharded_stoch_runner``. ``checkpoint_path`` with
    ``checkpoint_every_chunks`` snapshots both engines and the stoch
    generators into one file; ``resume_from`` restores them on the same
    mesh layout; ``log_every_chunks`` logs both engines; ``profile_dir``
    traces the loop."""
    from odesat_tpu_torch.models.loop import drive_chunks
    from odesat_tpu_torch.models.ode import (
        check_mesh_shape,
        formula_device,
        init_state,
        make_chunk_runner,
        resolve_strategy,
        seeded_generator,
        state_dtype,
    )
    from odesat_tpu_torch.models.stoch import (
        generator_states,
        init_stoch_state,
        make_stoch_chunk_runner,
        restore_generators,
    )
    from odesat_tpu_torch.interop import state_from_numpy, stoch_state_from_numpy
    from odesat_tpu_torch.parallel.dist import fetch
    from odesat_tpu_torch.parallel.sharded import row_generator
    from odesat_tpu_torch.utils.checkpoint import (
        load_generator_states,
        load_hybrid_state,
        mesh_layout_of,
        save_hybrid_state,
        validate_mesh_layout,
    )
    from odesat_tpu_torch.utils.device import entry_device
    from odesat_tpu_torch.utils.logging import log_chunk

    config = config or SolverConfig()
    device = entry_device(device)
    fa = hybrid_arrays(formula_or_arrays, config, mesh)
    ode = config.ode
    if mesh is None or mesh.n_clause == 1:
        strategy = resolve_strategy(fa, ode, device)
        if ode.dv_strategy == "auto":
            logger.info("dv_strategy auto -> %s on %s", strategy, device)
        ode = dataclasses.replace(ode, dv_strategy=strategy)
    zeta = ode.resolve_zeta(fa.density)
    if generator is None:
        if mesh is not None and config.seed is None:
            raise ValueError("a mesh run needs a seed: every rank draws the same initial state")
        generator = seeded_generator(config, "cpu")
    ode_seed, stoch_seed = (int(torch.randint(0, 2**63 - 1, (1,), generator=generator))
                            for _ in ENGINES)
    stoch_gen = row_generator(stoch_seed, mesh)
    chunk = config.chunk_steps

    @functools.lru_cache(maxsize=4)
    def engines(n):
        """(ode_runner, stoch_runner) advancing every row n steps: one
        builder for the steady-state and tail runners."""
        if mesh is None:
            return (make_chunk_runner(fa, zeta, ode, n, device),
                    make_stoch_chunk_runner(fa, n, device, stoch_gen,
                                            matmul_dtype=ode.matmul_dtype))
        from odesat_tpu_torch.parallel.sharded import (
            make_sharded_chunk_runner,
            make_sharded_stoch_runner,
        )

        return (make_sharded_chunk_runner(fa, zeta, ode, n, mesh, device),
                make_sharded_stoch_runner(fa, n, mesh, device, stoch_gen, ode.matmul_dtype,
                                          shard_chunk=ode.shard_chunk))

    steps_resumed = 0
    if config.resume_from:
        ode_l, stoch_l, steps_resumed, layout = load_hybrid_state(
            config.resume_from, ODEState, StochState)
        # both axes: the clause axis orders the clauses of both engines, the
        # traj axis the stoch generators
        validate_mesh_layout(layout, mesh, what="hybrid snapshot")
        ode_state = state_from_numpy(*ode_l, device=device)
        stoch_state = stoch_state_from_numpy(*stoch_l, device=device)
        # the stoch runner draws its seeds when built; the snapshot's
        # generator states then replace what the draw left
        restore_generators(load_generator_states(config.resume_from), stoch_gen,
                           engines(chunk)[1], mesh, what="hybrid snapshot")
    else:
        ode_gen = torch.Generator(device=device).manual_seed(ode_seed)
        ode_state = init_state(fa, config.batch_size, ode_gen, ode, device)
        stoch_state = init_stoch_state(fa, config.batch_size, device)
    dev = formula_device(fa, device, dtype=state_dtype(ode))
    sync = None
    if mesh is not None:
        from odesat_tpu_torch.parallel.dist import MeshSync
        from odesat_tpu_torch.parallel.sharded import shard_inputs, shard_stoch_inputs

        check_mesh_shape(ode_state.v.shape[0], fa, mesh)
        ode_state, dev = shard_inputs(ode_state, dev, mesh)
        stoch_state = shard_stoch_inputs(stoch_state, mesh)
        sync = MeshSync(mesh, device)

    clock = EngineClock(device)

    def make_runner(n):
        run_ode, run_stoch = engines(n)

        def run(st: HybridState) -> HybridState:
            clock.totals()  # the last pair has finished: its done flags were read
            a = clock.mark()
            ode_out = run_ode(st.ode, dev)
            b = clock.mark()
            stoch_out = run_stoch(st.stoch)
            clock.add((a, b, clock.mark()))
            return HybridState(ode_out, stoch_out)

        return run

    winner = []

    def should_stop(st, done):
        # the ODE engine first: a tie goes to "ode" (JAX :250-275)
        for col, name in enumerate(ENGINES):
            rows = np.flatnonzero(done[:, col])
            if rows.size:
                winner.append((name, int(rows[0])))
                return True
        return False

    def save(st, n):
        extra = generator_states(stoch_gen, engines(chunk)[1], mesh, device)
        save_hybrid_state(config.checkpoint_path, st.ode, st.stoch, n,
                          mesh_layout=mesh_layout_of(mesh), mesh=mesh, extra=extra)

    def log(st, n):
        log_chunk(st.ode, n)
        log_chunk(st.stoch, n)

    state, steps, wall = drive_chunks(
        HybridState(ode_state, stoch_state),
        make_runner,
        config,
        budget=ode.steps,
        should_stop=should_stop,
        steps_resumed=steps_resumed,
        chunk_steps=chunk,
        sync=sync,
        save=save,
        log=log,
        grow=False,
        cadence_first=True,
    )
    if mesh is not None:
        from odesat_tpu_torch.parallel.sharded import check_replicated

        check_replicated(state.ode.v, mesh)
        check_replicated(state.stoch.v, mesh)
    engine, idx = winner[0] if winner else ("none", 0)
    if engine == "stoch":
        assignment = fetch(state.stoch.v[:, : fa.n_vars], mesh)[idx]
    else:  # the winning ODE row, or ODE row 0 with no winner (JAX :279-285)
        assignment = fetch(state.ode.v[:, : fa.n_vars] > 0.0, mesh)[idx]
    return HybridResult(engine=engine, assignment=assignment, solved=bool(winner), steps=steps,
                        wall_time_s=wall, engine_seconds=clock.totals())
