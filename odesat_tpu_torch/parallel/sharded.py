"""Mesh-sharded solve paths on ``torch.distributed``: the port of
``odesat_tpu.parallel.sharded``.

Two axes, as in the JAX package (the reference has neither):

* ``traj``: the trajectory (chain) batch splits over ranks as pure data
  parallelism. Each rank runs the single-device ladder on its rows (B1,
  then B2, then the twin; for stoch B3, then B4, then the twin); the only
  traffic is the stop flag before each chunk: on a card, through B1-B4 on
  one host, exchanged between the ranks' device loops on the card
  (:func:`make_sharded_multi_runner`), else all-reduced by the host loop.
* ``clause``: the clause axis splits over the ranks of a trajectory row.
  Every step each rank evaluates its clause segment and the partials are
  all-reduced over the row's clause group; ``v`` is replicated over the
  group. ``ODEConfig.shard_chunk`` picks the kernels as the JAX package
  does: 'auto' and 'on' run the clause-sharded chunk (B6 for the ODE, B9
  for stoch: the update after each all-reduce runs in the next launch),
  'off' the per-step path (B5 or B8 and the update in torch). A formula
  that neither kernel takes runs the torch twin, with a warning on CUDA.

Every rank builds the *global* initial state from the seed and keeps its
rows and segment, so a T x S run starts from the unsharded run's state.
The stoch clause path draws its uniforms with the counter hash
(``ops/stoch_chunk.uniform01``) from a per-chunk seed taken from a CPU
generator seeded with (seed, trajectory row): the same on every clause
rank of a row, so S=2 flips exactly as S=1 does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays, compile_formula
from odesat_tpu_torch.parallel.dist import (
    MeshSync,
    all_reduce,
    fetch,
    local_block,
    local_rows,
    row_block,
)
from odesat_tpu_torch.utils.logging import logger


def _n_clause(mesh) -> int:
    return 1 if mesh is None else mesh.n_clause


def _twin_on_card(device, what: str) -> None:
    """Say loudly that a clause mesh runs the torch twin on a card (its sums
    and maxima run on B7's standalone call, its step in torch ops)."""
    if torch.device(device).type == "cuda":
        logger.warning("clause mesh on %s runs the torch twin, not a chunk kernel (its sums on "
                       "B7's standalone call): %s", device, what)


# "dist" sends every twin step's reduction through torch.distributed, the
# route before B7 took them: the yardstick chip_smoke.py's phase 29 and a
# card test hold B7's route against. No flag sets it.
TWIN_ROUTE = None


def traj_reduce_route(n_traj: int, device, hosts) -> tuple:
    """Where a twin step's batch-shared error max over the trajectory
    group reduces: ``("b7", why)`` for B7's standalone call (its kernel on
    a card, its plain version on the CPU), ``("dist", why)`` for
    ``torch.distributed``. ``hosts``: the group's ranks' host names. B7 on
    a card needs every rank of the group on this host (its slots are CUDA
    IPC mappings); a group over hosts keeps ``torch.distributed`` (JAX
    reduces over DCN there)."""
    if torch.device(device).type != "cuda":
        return "b7", f"the plain version on {device}"
    if n_traj > 1 and len(set(hosts)) > 1:
        return "dist", (f"the trajectory group spans hosts {sorted(set(hosts))}: CUDA IPC "
                        "pages stay within one")
    return "b7", f"{n_traj} ranks on one host, B7 on the card"


def twin_routes(mesh, device, shared: bool) -> dict:
    """``make_step_fn``'s routes for a twin step on ``mesh``, decided when
    the runner is built and logged: the clause group always on B7 (a pod
    keeps it inside one process, ``multihost.make_pod_mesh``), the
    trajectory group (``shared``: a batch-shared adaptive dt) by
    :func:`traj_reduce_route` (its hosts gathered once, a collective)."""
    routes = {"clause_route": "b7", "traj_route": "b7"}
    if shared and mesh.n_traj > 1:
        cuda = torch.device(device).type == "cuda"
        route, why = traj_reduce_route(mesh.n_traj, device, traj_hosts(mesh) if cuda else ())
        logger.info("mesh %dx%d twin step's shared-dt max over the trajectory group -> %s on "
                    "%s: %s", mesh.n_traj, mesh.n_clause, route, device, why)
        routes["traj_route"] = route
    if TWIN_ROUTE is not None:
        routes = dict.fromkeys(routes, TWIN_ROUTE)
    return routes


def compile_for_mesh(formula, config, mesh, engine: str = "ode") -> FormulaArrays:
    """The formula laid out for the mesh (JAX :65-103). On a clause axis,
    the clause-sharded layout of :func:`compile_stream_sharded` (its plan in
    ``fa.shard_plan``) when the engine's clause-shard kernels take it: for
    the ODE (``engine="ode"``) B5's and B6's gate with the run's config,
    for stoch B8's and B9's (:func:`~odesat_tpu_torch.ops.stoch_chunk.
    stoch_shard_supported`, which takes unit clauses); otherwise the plain
    layout with the clause axis padded to divide evenly. A trajectory-only
    mesh keeps the single-device layout (``models/ode.compile_for_config``),
    so that every row computes as it does on one device, bit for bit."""
    n_clause = _n_clause(mesh)
    if n_clause == 1:
        from odesat_tpu_torch.models.ode import compile_for_config

        return compile_for_config(formula, config)
    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded, stream_shard_supported
    from odesat_tpu_torch.ops.stoch_chunk import stoch_shard_supported

    ode = config.ode
    if engine == "stoch" or (ode.dtype == "float32" and ode.dv_strategy in ("auto", "stream")
                             and not (ode.dt_mode == "shared" and ode.step_size is None)):
        fa, plan = compile_stream_sharded(formula, n_clause, var_pad=config.var_pad,
                                          bucket=config.bucket != "off",
                                          window_sort=config.window_sort)
        if (stoch_shard_supported(fa) if engine == "stoch"
                else stream_shard_supported(fa, plan, ode.dtype)):
            return fa
    return compile_formula(formula, clause_pad=config.clause_pad * n_clause,
                           var_pad=config.var_pad)


def shard_state(state, mesh):
    """This rank's rows and clause segment of a global ODE state."""
    return type(state)(
        v=local_rows(state.v, mesh).contiguous(),
        xs=local_block(state.xs, mesh).contiguous(),
        xl=local_block(state.xl, mesh).contiguous(),
        dt=local_rows(state.dt, mesh).contiguous(),
        done=local_rows(state.done, mesh).contiguous(),
    )


def shard_inputs(state, dev, mesh):
    """This rank's block of the state and its clause segment of the
    formula tensors (JAX :106-119); the occurrence tables stay whole (only
    the scan path's gather reads them, and a clause mesh sums by
    segment)."""
    from odesat_tpu_torch.models.ode import FormulaDevice

    n = mesh.n_clause
    per = dev.clause_mask.shape[0] // n
    seg = slice(mesh.clause_index * per, (mesh.clause_index + 1) * per)
    dev = FormulaDevice(dev.lit_var[:, seg], dev.sign[:, seg], dev.lit_mask[:, seg],
                        dev.clause_mask[seg], dev.var_occ, dev.occ_mask)
    return shard_state(state, mesh), dev


def shard_stoch_inputs(state, mesh):
    """This rank's chains and clause segment of a global stoch state."""
    return type(state)(v=local_rows(state.v, mesh).contiguous(),
                       xl=local_block(state.xl, mesh).contiguous(),
                       done=local_rows(state.done, mesh).contiguous())


def _clause_eligible(fa, ode, n_clause) -> bool:
    from odesat_tpu_torch.ops.shard_stream import stream_shard_supported

    plan = fa.shard_plan
    shared_adaptive = ode.dt_mode == "shared" and ode.step_size is None
    return (plan is not None and plan.n_shards == n_clause and not shared_adaptive
            and stream_shard_supported(fa, plan, ode.dtype))


def make_sharded_chunk_runner(fa: FormulaArrays, zeta: float, ode, chunk_steps: int, mesh,
                              device):
    """``run(state, dev) -> state`` for this rank's block (JAX :417-624).

    A trajectory-only mesh runs the single-device ladder B1 -> B2 -> twin
    on the rank's rows (a batch-shared adaptive dt reduces its error over
    the traj group). A clause mesh with an eligible plan and config runs
    the clause-sharded chunk B6 (``shard_chunk`` 'auto' or 'on') or B5's
    per-step clause step ('off'); otherwise the twin's clause step (local
    ``segment_sum``, partial dv all-reduced), with a warning on CUDA;
    'on' without an eligible plan raises. Every choice is logged as the
    single-device ladders log theirs."""
    import dataclasses

    from odesat_tpu_torch.models.ode import make_chunk_runner, make_step_fn, resolve_strategy

    n_clause = mesh.n_clause
    shared_adaptive = ode.dt_mode == "shared" and ode.step_size is None
    if shared_adaptive and ode.dv_strategy in ("fused", "stream"):
        raise ValueError(
            "dt_mode='shared' is not supported by the chunk kernels; "
            "use dv_strategy='auto' (scan path) or per-trajectory dt"
        )
    if n_clause == 1:
        if not shared_adaptive or mesh.n_traj == 1:
            return make_chunk_runner(fa, zeta, ode, chunk_steps, device)
        routes = twin_routes(mesh, device, True)
        step = make_step_fn(fa, zeta, dataclasses.replace(
            ode, dv_strategy=resolve_strategy(fa, ode, device)), traj_group=mesh.traj_group,
            device=device, **routes)
        return _step_chunk(step, chunk_steps, mesh, device, routes)

    from odesat_tpu_torch.ops.shard_chunk import resolve_shard_chunk, shard_chunk_supported

    if ode.dv_strategy == "fused":
        raise ValueError(
            "dv_strategy='fused' does not support a clause mesh axis; "
            "use dv_strategy='auto'/'stream' or a trajectory-only mesh"
        )
    plan = fa.shard_plan
    eligible = _clause_eligible(fa, ode, n_clause)
    if plan is not None and not eligible:
        why = (
            f"dtype={ode.dtype!r}" if ode.dtype != "float32"
            else "dt_mode='shared' with the adaptive integrator" if shared_adaptive
            else f"plan has {plan.n_shards} shards but the mesh {n_clause}"
            if plan.n_shards != n_clause
            else "the formula is past the kernel's gate"
        )
        raise ValueError(
            "this formula was compiled with a clause-shard plan but the run config is "
            f"ineligible for the clause-shard kernel ({why}); recompile via compile_for_mesh "
            "with the run-time config"
        )
    if ode.dv_strategy == "stream" and not eligible:
        raise ValueError(
            "dv_strategy='stream' on a clause mesh needs a formula compiled via "
            "compile_for_mesh (clause-sharded plan) with no unit clauses, dtype=float32, "
            "per-trajectory dt"
        )
    whole_ok = eligible and shard_chunk_supported(fa, plan, ode)
    whole = resolve_shard_chunk(ode.shard_chunk, whole_ok)
    if whole and not whole_ok:
        raise ValueError(
            "shard_chunk='on' needs a clause-shard plan eligible for the chunk kernel "
            "(compile via compile_for_mesh; no unit clauses, float32 state, per-trajectory dt)"
        )
    if eligible and ode.dv_strategy in ("auto", "stream"):
        from odesat_tpu_torch.ops.shard_stream import make_clause_chunk, make_fused_clause_step

        if whole:
            from odesat_tpu_torch.ops.shard_chunk import make_shard_chunk

            logger.info("clause mesh %dx%d -> shard_chunk (B6) on %s", mesh.n_traj, n_clause,
                        device)
            return make_shard_chunk(fa, zeta, ode, chunk_steps, mesh.clause_group, device)
        logger.info("clause mesh %dx%d -> shard_stream (B5) on %s", mesh.n_traj, n_clause,
                    device)
        return make_clause_chunk(
            make_fused_clause_step(fa, zeta, ode, mesh.clause_group, device), chunk_steps)
    logger.info("clause mesh %dx%d -> twin clause step (segment_sum) on %s", mesh.n_traj,
                n_clause, device)
    _twin_on_card(device, "the formula or config is past the clause-shard kernels' gate")
    routes = twin_routes(mesh, device, shared_adaptive)
    step = make_step_fn(fa, zeta, ode, clause_group=mesh.clause_group,
                        traj_group=mesh.traj_group, device=device, **routes)
    return _step_chunk(step, chunk_steps, mesh, device, routes)


def _step_chunk(step, chunk_steps, mesh=None, device="cpu", routes=None):
    """``chunk_steps`` of the twin's mesh step as one runner (JAX :597-624,
    one jitted, donated ``lax.scan``): the scan chunk
    (``ops/scan_chunk.py``), captured once a shape as a CUDA graph with
    its B7 calls on a card and run in place on its buffers, the loop of
    steps on the CPU. A group on the ``torch.distributed`` route
    (:func:`twin_routes`: a trajectory group over hosts) cannot be
    captured, so that runner stays host-paced, said at INFO."""
    from odesat_tpu_torch.ops.scan_chunk import ScanChunk

    dist_route = [name for name, route in (routes or {}).items() if route == "dist"]
    if dist_route and torch.device(device).type == "cuda":
        logger.info("mesh %dx%d twin step's chunk -> host-paced on %s: %s takes "
                    "torch.distributed, which a CUDA graph cannot hold", mesh.n_traj,
                    mesh.n_clause, device, " and ".join(dist_route))

        def run(state, dev):
            for _ in range(chunk_steps):
                state = step(state, dev)
            return state

        return run
    return ScanChunk(step, chunk_steps, device, counter="mesh_launches",
                     calls=getattr(step, "calls", None), prepare=getattr(step, "prepare", None))


_HOSTS: dict = {}  # traj group -> its ranks' host names, rank order


def traj_hosts(mesh) -> tuple:
    """The host names of this rank's trajectory group, rank order (gathered
    once a group: a collective the first time)."""
    import socket

    import torch.distributed as dist

    hosts = _HOSTS.get(mesh.traj_group)
    if hosts is None:
        seen = [None] * mesh.n_traj
        dist.all_gather_object(seen, socket.gethostname(), group=mesh.traj_group)
        hosts = _HOSTS[mesh.traj_group] = tuple(seen)
    return hosts


def mesh_loop_route(chunk, n_traj: int, n_clause: int, device, hosts) -> tuple:
    """Where a mesh's multi-chunk dispatch of ``chunk`` runs: ``("device",
    why)`` for the device loop (``ops/device_loop.py``: one graph launch a
    rank, the stop exchanged between the ranks on the card), ``("host",
    why)`` for ``models/loop.run_chunks`` with ``parallel/dist.MeshSync``.
    JAX's eligibility (``sharded_multi_supported``,
    ``sharded_multi_stoch_supported``, JAX :340-356): a trajectory-only mesh
    (``n_clause`` 1) whose chunk is a kernel's runner (B1-B4), here on a
    CUDA ``device`` with every rank of the trajectory group on one host
    (``hosts``, its ranks' host names): the exchange's pages are CUDA IPC
    mappings. Clause meshes, the scan tier (the twin, ``--dv-strategy
    pallas``), batch-shared adaptive dt (a twin step that all-reduces dt)
    and a group over hosts stay host-paced."""
    from odesat_tpu_torch.ops.device_loop import KernelChunk
    from odesat_tpu_torch.ops.scan_chunk import ScanChunk

    if torch.device(device).type != "cuda":
        return "host", f"the plain version on {device}"
    if n_clause > 1:
        return "host", f"a clause mesh ({n_traj}x{n_clause}) is host-paced, as in JAX"
    if not isinstance(chunk, KernelChunk):
        return "host", "the chunk is the twin's steps (batch-shared adaptive dt), no kernel's"
    if isinstance(chunk, ScanChunk):
        return "host", "the scan tier's chunk is host-paced on a mesh, as in JAX"
    if n_traj > 1 and len(set(hosts)) > 1:
        return "host", (f"the trajectory group spans hosts {sorted(set(hosts))}: CUDA IPC "
                        "pages stay within one (JAX reduces over DCN there)")
    return "device", (f"{n_traj} ranks exchange the stop on the card" if n_traj > 1 else
                      "one rank")


def make_sharded_multi_runner(chunk, chunk_steps: int, max_chunks: int, mesh, device,
                              stop_on: str = "any", dev=None):
    """``run(state) -> (state, steps_advanced)``: up to ``max_chunks`` calls
    of the chunk runner ``chunk`` (``chunk(state, dev)`` for the ODE, with
    the formula tensors ``dev``; ``chunk(state)`` for stoch, ``dev`` None),
    with the stop flag reduced over the trajectory group before every chunk,
    so every rank stops before the same one (a state stopped at entry on any
    rank, on every rank with ``stop_on="all"``, runs none) and
    ``steps_advanced`` is exact (JAX :332-414, :862-922), for either engine.
    :func:`mesh_loop_route` decides, logged: a kernel's runner (B1-B4) on a
    card with the whole group on one host runs each dispatch as one
    device-loop graph launch a rank, the stop exchanged on the card (B3's
    and B4's ``max_chunks`` seeds drawn first from the rank's row generator,
    in the host loop's order); anything else runs the host loop of
    ``models/loop.run_chunks`` with ``MeshSync`` (the plain version). A
    failure of the device loop raises: nothing falls back."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.ops import device_loop

    stop_all = stop_on == "all"
    cuda_traj = torch.device(device).type == "cuda" and mesh.n_clause == 1 and mesh.n_traj > 1
    hosts = traj_hosts(mesh) if cuda_traj else ()
    route, why = mesh_loop_route(chunk, mesh.n_traj, mesh.n_clause, device, hosts)
    logger.info("mesh %dx%d multi-chunk dispatch -> %s loop on %s: %s", mesh.n_traj,
                mesh.n_clause, route, device, why)
    if route == "host":
        call = chunk if dev is None else (lambda st: chunk(st, dev))
        return run_chunks(call, chunk_steps, max_chunks, stop_all=stop_all,
                          sync=MeshSync(mesh, device))
    from odesat_tpu_torch.models.stoch import draw_seed
    from odesat_tpu_torch.parallel.multihost import collective_timeout

    peers = (device_loop.mesh_peers(mesh.traj_group, device, collective_timeout())
             if mesh.n_traj > 1 else None)

    def run(state):
        seeds = None
        if chunk.generator is not None:
            seeds = [draw_seed(chunk.generator) for _ in range(max_chunks)]
        return device_loop.run(chunk, state, max_chunks, stop_all=stop_all, seeds=seeds,
                               dev=dev, peers=peers)

    return run


def check_replicated(v: torch.Tensor, mesh) -> None:
    """Raise unless ``v`` (float32, float64 or bool) is bit-identical on every clause
    rank of this row: its bits all-reduced with MAX equal their MIN (the
    negation's MAX)."""
    if mesh is None or mesh.n_clause == 1:
        return
    x = v.detach().contiguous()
    # a float64 word as its two 32-bit halves: negating a widened half
    # cannot overflow
    bits = (x.view(torch.int32) if x.is_floating_point() else x.to(torch.int32)).long()
    hi = all_reduce(bits.clone(), mesh.clause_group, op="max")
    lo = all_reduce(-bits, mesh.clause_group, op="max")
    if not torch.equal(hi, -lo):
        raise RuntimeError("v differs between the clause ranks of a trajectory row: the "
                           "replicated state diverged")


# ------------------------------------------------------------------ stoch


def row_generator(seed: int, mesh) -> torch.Generator:
    """A CPU generator seeded from (seed, this rank's trajectory row): the
    same on every clause rank of a row, another on every row (the
    counterpart of JAX's per-device keys, :634-638)."""
    row = 0 if mesh is None else mesh.traj_index
    state = np.random.SeedSequence([int(seed), row]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def make_clause_stoch_runner(fa: FormulaArrays, chunk_steps: int, device, generator,
                             clause_group=None, matmul_dtype: str = "float32",
                             shard_chunk="auto"):
    """``run(state) -> state`` for the stoch clause path over this rank's
    clause segment. With a shard plan (``stoch_shard_supported``): the
    clause-sharded chunk B9 (``ops/stoch_chunk.make_stoch_shard_chunk``)
    for ``shard_chunk`` 'auto' or 'on', B8 (``make_stoch_shard_eval``)
    with the flips drawn in torch (``models/stoch.make_stoch_clause_step``)
    for 'off'. Without one, the twin's evaluation over the plain layout's
    segment, with a warning on CUDA ('on' raises). The sums and the sat
    flag are all-reduced over ``clause_group``; every path takes one seed
    a chunk from ``generator`` and the same counter-hash uniforms, so they
    flip alike. Runnable at S=1 without a group. Every route's run consumes
    its input, as JAX's ``donate_argnums=0`` (``ops/device_loop.py`` states
    the contract): B9's and B8's chains are tiled and updated in the
    caller's storage and the result is returned in it, with every buffer
    held for the batch shape; the twin's chunk runs on a scan chunk's
    buffers. On a card B8's and the twin's steps run as one CUDA graph
    replay a chunk (``ops/scan_chunk.py``), their seed in a word on the
    card (``Uniforms.word``)."""
    import torch.distributed as dist

    from odesat_tpu_torch.models.stoch import (
        StochState,
        make_stoch_clause_eval,
        make_stoch_clause_step,
    )
    from odesat_tpu_torch.ops.scan_chunk import ScanChunk, TiledChunk
    from odesat_tpu_torch.ops.shard_chunk import resolve_shard_chunk
    from odesat_tpu_torch.ops.stoch_chunk import (
        TiledUniforms,
        Uniforms,
        make_stoch_shard_chunk,
        make_stoch_shard_eval,
        stoch_shard_supported,
        traj_block,
    )
    from odesat_tpu_torch.ops.tiles import TILE, Tiles, held_pool, n_tiles

    shard = 0 if clause_group is None else dist.get_rank(clause_group)
    eligible = stoch_shard_supported(fa)
    whole = resolve_shard_chunk(shard_chunk, eligible)
    if whole and not eligible:
        raise ValueError("shard_chunk='on' needs a clause-shard plan layout (compile via "
                         "compile_for_mesh) whose v fits one CTA")
    if whole:
        chunk = make_stoch_shard_chunk(fa, chunk_steps, device, shard, clause_group,
                                       matmul_dtype)
        logger.info("stoch clause path -> stoch_shard_chunk (B9) on %s", device)

        def run_chunk(state):
            return chunk(state, int(torch.randint(0, 2**31 - 1, (1,), generator=generator)))

        run_chunk.held = chunk.held
        return run_chunk
    Np = fa.n_vars_padded

    def calls(acc_shape):
        """A step's one B7 call: the (total | unsat | 1 - sat) sum."""
        return lambda state: [(clause_group, acc_shape(state.v.shape), torch.float32)]

    if not eligible:
        n = 1 if clause_group is None else dist.get_world_size(clause_group)
        step = make_stoch_clause_step(make_stoch_clause_eval(fa, device, shard, n).packed,
                                      clause_group)
        logger.info("stoch clause path -> twin clause evaluation on %s", device)
        _twin_on_card(device, "the stoch formula has no clause-shard plan")
        twins: dict = {}  # (batch, device) -> (the uniforms, the chunk drawing them)

        def run_twin(state):
            # the steps and their draws as one scan chunk (JAX :782-794), its
            # seed in the uniforms' word; the call consumes its input
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
            B, dev = state.v.shape[0], state.v.device
            hit = twins.get((B, dev))
            if hit is None:
                chains = torch.arange(B, device=dev, dtype=torch.int64).unsqueeze(1)
                uniforms = Uniforms(chains, torch.arange(Np, device=dev, dtype=torch.int64)
                                    .unsqueeze(0), traj_block(B))
                hit = twins[B, dev] = (uniforms, ScanChunk(
                    lambda st, _, u=uniforms: step(st, u.next()), chunk_steps, dev,
                    counter="mesh_launches", calls=calls(lambda s: (s[0], 2 * Np + 1))))
            uniforms, chunk = hit
            uniforms.set_seed(seed)
            return chunk(state)

        run_twin.twins = twins
        return run_twin
    ev = make_stoch_shard_eval(fa, device, shard, matmul_dtype)
    logger.info("stoch clause path -> stoch_shard_eval (B8) on %s", device)
    # ("B8", shard, batch, device) -> (Tiles, the uniforms, acc, w, the step's work pair)
    held = held_pool(fa)
    chunks: dict = {}  # the same key -> this runner's chunk on those buffers

    def run(state):
        # the chains tiled once a chunk in their own storage (a ragged
        # batch through buffers held for it): B8's launches, the all-reduce,
        # the uniforms (drawn in tile order from the seed word) and the
        # flips all work on the tiles, writing into buffers held for the
        # batch shape, so the call consumes its input as JAX's donated one
        # and returns its storage; on a card the steps are one capture,
        # replayed (JAX :721-759, one jitted lax.scan)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        B, dev = state.v.shape[0], state.v.device
        key = ("B8", shard, B, dev)
        h = held.get(key)
        if h is None:
            G = n_tiles(B)
            acc = w = None
            if dev.type == "cuda":  # B8's buffers
                acc = torch.empty((G, 2 * Np + 1, TILE), dtype=torch.float32, device=dev)
                w = torch.empty((G, ev.spec.Mp, TILE), dtype=torch.int32, device=dev)
            work = (torch.empty((G, Np, TILE), dtype=torch.bool, device=dev),
                    torch.empty((G, TILE), dtype=torch.bool, device=dev))
            h = held[key] = (Tiles(), TiledUniforms(G, traj_block(B), Np, dev), acc, w, work)
        tiles, uniforms, acc, w, work = h
        chunk = chunks.get(key)
        if chunk is None:
            step = make_stoch_clause_step(
                lambda v, xl, done: ev.tiled(v, xl, done, acc, w), clause_group, work)
            chunk = chunks[key] = TiledChunk(
                lambda ts, _: step(ts, uniforms.next()), chunk_steps, dev, tiles,
                dict(xl=1, done=True), calls=calls(lambda s: (s[0], 2 * Np + 1, TILE)))
        uniforms.set_seed(seed)
        return chunk(state)

    run.held, run.chunks = held, chunks
    return run


def make_sharded_stoch_runner(fa: FormulaArrays, chunk_steps: int, mesh, device, generator,
                              matmul_dtype: str = "float32", fused: str = "auto",
                              shard_chunk="auto"):
    """``run(state) -> state`` for this rank's chains (JAX :627-846): a
    trajectory-only mesh runs B3 -> B4 -> twin on the rank's rows with the
    row's generator; a clause mesh runs :func:`make_clause_stoch_runner`
    (B9 or B8 on a shard-plan layout, else the twin)."""
    from odesat_tpu_torch.models.stoch import make_stoch_chunk_runner

    if mesh.n_clause == 1:
        return make_stoch_chunk_runner(fa, chunk_steps, device, generator, fused=fused,
                                       matmul_dtype=matmul_dtype)
    plan = fa.shard_plan
    if plan is not None and plan.n_shards != mesh.n_clause:
        raise ValueError(f"plan has {plan.n_shards} shards but the mesh {mesh.n_clause}")
    return make_clause_stoch_runner(fa, chunk_steps, device, generator, mesh.clause_group,
                                    matmul_dtype, shard_chunk)


def fetch_state(state, mesh):
    """Every field of a rank's ODE (or stoch) state gathered to the host on
    every rank: rows over the traj axis, xs/xl segments over the clause
    axis."""
    out = {}
    for name in state._fields:
        out[name] = fetch(getattr(state, name), mesh, clause_sharded=name in ("xs", "xl"))
    return type(state)(**out)


def simulate_batch_sharded(formula, config, mesh, *, device="cuda", generator=None, v0=None,
                           stop_on: str = "any"):
    """The mesh-sharded batched solve (JAX :939-952): ``formula`` compiled
    for the mesh (:func:`compile_for_mesh`, unless it is compiled already),
    then ``models/ode.simulate_batch`` on ``mesh``. Called on every rank of
    the world (``parallel/launch.spawn``); the result holds the global
    batch on every rank."""
    from odesat_tpu_torch.models.ode import simulate_batch

    fa = formula if isinstance(formula, FormulaArrays) else \
        compile_for_mesh(formula, config, mesh)
    return simulate_batch(fa, config, device=device, generator=generator, v0=v0,
                          stop_on=stop_on, mesh=mesh)


# --------------------------------------------- runs for parity checks
#
# Module-level functions that parallel/launch.spawn can run on every rank:
# the tests and chip_smoke.py hold a mesh run against the same run on one
# device with them.


def run_ode_cases(mesh, device, cases):
    """For each ``(fa, zeta, ode, steps, arrays)``: shard the global NumPy
    state ``arrays`` (v, xs, xl, dt, done), run ``steps`` steps through
    :func:`make_sharded_chunk_runner` and return on every rank the global
    state as NumPy (v, xs, xl, dt, done) and, sixth, the final
    v of every clause rank of this rank's trajectory row, stacked (rank
    0's: the first row's)."""
    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.models.ode import formula_device, state_dtype

    out = []
    for fa, zeta, ode, steps, arrays in cases:
        # a copy: the runner consumes its input, which on the CPU would be
        # the arrays themselves, and cases may share them
        state = state_from_numpy(*(np.copy(a) for a in arrays), device=device)
        dev = formula_device(fa, device, dtype=state_dtype(ode))
        state, dev = shard_inputs(state, dev, mesh)
        state = make_sharded_chunk_runner(fa, zeta, ode, steps, mesh, device)(state, dev)
        check_replicated(state.v, mesh)
        copies = state.v.new_zeros((mesh.n_clause, *state.v.shape))
        copies[mesh.clause_index] = state.v
        all_reduce(copies, mesh.clause_group)
        out.append((*fetch_state(state, mesh), copies.cpu().numpy()))
    return out


def run_multi_cases(mesh, device, cases):
    """For each ``(fa, zeta, ode, chunk_steps, max_chunks, stop_on,
    arrays)``: shard the global NumPy state ``arrays`` (v, xs, xl, dt,
    done), run one dispatch of :func:`make_sharded_multi_runner` and return
    on every rank ``(state as NumPy, steps_advanced)``."""
    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.models.ode import formula_device, state_dtype

    out = []
    for fa, zeta, ode, chunk_steps, max_chunks, stop_on, arrays in cases:
        state = state_from_numpy(*(np.copy(a) for a in arrays), device=device)  # consumed
        dev = formula_device(fa, device, dtype=state_dtype(ode))
        state, dev = shard_inputs(state, dev, mesh)
        chunk = make_sharded_chunk_runner(fa, zeta, ode, chunk_steps, mesh, device)
        multi = make_sharded_multi_runner(chunk, chunk_steps, max_chunks, mesh, device, stop_on,
                                          dev)
        state, steps = multi(state)
        out.append((fetch_state(state, mesh), steps))
    return out


def run_multi_stoch_cases(mesh, device, cases):
    """For each ``(fa, chunk_steps, max_chunks, seed, arrays, fused)``:
    shard the global NumPy chains ``arrays`` (v, xl, done) over a
    trajectory-only mesh, run one dispatch of
    :func:`make_sharded_multi_runner` over each rank's chunk runner (its row
    generator from ``seed``) and return on every rank ``(state as NumPy,
    steps_advanced)``."""
    from odesat_tpu_torch.interop import stoch_state_from_numpy

    out = []
    for fa, chunk_steps, max_chunks, seed, arrays, fused in cases:
        state = shard_stoch_inputs(stoch_state_from_numpy(*(np.copy(a) for a in arrays),
                                                          device=device), mesh)  # consumed
        chunk = make_sharded_stoch_runner(fa, chunk_steps, mesh, device,
                                          row_generator(seed, mesh), fused=fused)
        state, steps = make_sharded_multi_runner(chunk, chunk_steps, max_chunks, mesh,
                                                 device)(state)
        out.append((fetch_state(state, mesh), steps))
    return out


def loop_against_host_loop(mesh, device, cases):
    """The trajectory mesh's device loop against its plain version, the
    host loop (``models/loop.run_chunks`` with ``MeshSync``), over the same
    kernel on this rank's card: for each case, ``("ode", fa, ode,
    chunk_steps, bound, stop_on, arrays)`` (B1 or B2 as ``ode.dv_strategy``
    and the gates pick; ``arrays`` the global v, xs, xl, dt, done) or
    ``("stoch", fa, fused, chunk_steps, bound, seed, arrays)`` (B3 or B4;
    v, xl, done; each run's own row generator from ``seed``), one dispatch
    of each from the same state; ``arrays`` may instead be ``(B, seed,
    rows)``: the state :func:`random_mesh_state` makes, with the global
    rows ``rows`` done. Returns on every rank, a case, ``(err,
    steps, host_steps, graphs, launches)``: the largest
    :func:`~odesat_tpu_torch.parallel.dist.bit_error` between the two
    states over every field and rank (0.0: bit for bit; a bool field that
    differs counts inf, as do steps or, after a dispatch that ran every
    chunk, generator states that differ on any rank), the two
    ``steps_advanced``, and this rank's mesh graph launches and kernel
    launches of the device loop's dispatch."""
    import torch.distributed as dist

    from odesat_tpu_torch.interop import state_from_numpy, stoch_state_from_numpy
    from odesat_tpu_torch.models.loop import copy_state, run_chunks
    from odesat_tpu_torch.ops import device_loop
    from odesat_tpu_torch.parallel.dist import bit_error

    out = []
    for engine, fa, how, chunk_steps, bound, rule, arrays in cases:
        if isinstance(arrays[0], int):
            state = random_mesh_state(engine, fa, *arrays, mesh, device)
        elif engine == "ode":
            state = shard_state(state_from_numpy(*arrays, device=device), mesh)
        else:
            state = shard_stoch_inputs(stoch_state_from_numpy(*arrays, device=device), mesh)
        if engine == "ode":
            chunks = [make_sharded_chunk_runner(fa, how.resolve_zeta(fa.density), how,
                                                chunk_steps, mesh, device)] * 2
            stop_on, gens = rule, [None, None]
            host = run_chunks(lambda st: chunks[0](st, None), chunk_steps, bound,
                              stop_all=stop_on == "all", sync=MeshSync(mesh, device))
        else:
            gens = [row_generator(rule, mesh) for _ in range(2)]
            chunks = [make_sharded_stoch_runner(fa, chunk_steps, mesh, device, g, fused=how)
                      for g in gens]
            stop_on = "any"
            host = run_chunks(chunks[0], chunk_steps, bound, sync=MeshSync(mesh, device))
        want, host_steps = host(copy_state(state))  # a dispatch consumes its input
        multi = make_sharded_multi_runner(chunks[1], chunk_steps, bound, mesh, device, stop_on)
        mod, attr = chunks[1].counter
        graphs, before = device_loop.mesh_launches, getattr(mod, attr)
        got, steps = multi(state)
        graphs, launches = device_loop.mesh_launches - graphs, getattr(mod, attr) - before
        err = 0.0
        for a, b in zip(got, want):
            if a.dtype == torch.bool:
                err = max(err, 0.0 if torch.equal(a, b) else math.inf)
            else:
                err = max(err, bit_error(a.cpu().float(), b.cpu().float()))
        if steps != host_steps or (gens[0] is not None and steps == bound * chunk_steps and
                                   not torch.equal(gens[0].get_state(), gens[1].get_state())):
            err = math.inf
        worst = torch.tensor([err], dtype=torch.float64)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=mesh.traj_group)
        out.append((float(worst.item()), steps, host_steps, graphs, launches))
    return out


def random_mesh_state(engine: str, fa, B: int, seed: int, rows, mesh, device):
    """This rank's block of a random global state of ``B`` rows, the rows
    ``rows`` done, made on the rank (the clause memories of a large formula
    are too large to send): for "ode" v ~ U(-1, 1) from ``seed``, xs from
    the all-false valuation, xl = 1, dt = 0.01; for "stoch" v a fair coin,
    xl = 1."""
    from odesat_tpu_torch.interop import state_from_numpy, stoch_state_from_numpy

    rng = np.random.default_rng(seed)
    done = np.zeros(B, bool)
    done[list(rows)] = True
    block = row_block(B // mesh.n_traj, mesh)
    done = done[block]
    Np, Mp = fa.n_vars_padded, fa.n_clauses_padded
    if engine == "stoch":
        v = (rng.random((B, Np)) < 0.5)[block]
        return stoch_state_from_numpy(v, np.ones((done.size, Mp), np.int32), done,
                                      device=device)
    v = rng.uniform(-1, 1, (B, Np)).astype(np.float32)[block]
    xs = np.broadcast_to(fa.xs_init, (done.size, Mp)).astype(np.float32)
    return state_from_numpy(v, xs, np.ones_like(xs), np.full(done.size, 0.01, np.float32), done,
                            device=device)


def dispatch_alone(mesh, device, fa, chunk_steps: int = 8, wait_s: float = 120.0):
    """A trajectory mesh whose rank 0 dispatches while its peers never do:
    every rank builds the runner (the exchange pages are shared), then rank
    0 runs one dispatch of B1 and every other rank sleeps ``wait_s``. Rank
    0's exchange waits the collective timeout and raises, naming the ranks
    that did not arrive."""
    import time

    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.utils.config import ODEConfig

    ode = ODEConfig(step_size=0.01, dv_strategy="fused")
    chunk = make_sharded_chunk_runner(fa, 0.05, ode, chunk_steps, mesh, device)
    multi = make_sharded_multi_runner(chunk, chunk_steps, 4, mesh, device, dev=None)
    rng = np.random.default_rng(mesh.rank)
    B = 4
    xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
    state = state_from_numpy(rng.uniform(-1, 1, (B, fa.n_vars_padded)).astype(np.float32), xs,
                             np.ones_like(xs), np.full(B, 0.01, np.float32), np.zeros(B, bool),
                             device=device)
    if mesh.traj_index == 0:
        return multi(state)[1]
    time.sleep(wait_s)
    return None


def run_stoch_clause(mesh, device, fa, chunks: int, chunk_steps: int, seed: int,
                     matmul_dtype: str = "float32", batch: int = 8, shard_chunk="auto"):
    """``chunks`` chunks of the stoch clause path from the all-false start
    (no early stop), each row's generator from (seed, row), through B9
    (``shard_chunk`` 'auto') or B8 ('off'); returns the global (v, xl,
    done) as NumPy on every rank. With ``mesh`` None it runs S=1 in this
    process."""
    from odesat_tpu_torch.models.stoch import init_stoch_state

    n_traj = 1 if mesh is None else mesh.n_traj
    group = None if mesh is None else mesh.clause_group
    state = init_stoch_state(fa, batch * n_traj, device)
    if mesh is not None:
        state = shard_stoch_inputs(state, mesh)
    run = make_clause_stoch_runner(fa, chunk_steps, device, row_generator(seed, mesh), group,
                                   matmul_dtype, shard_chunk)
    for _ in range(chunks):
        state = run(state)
    check_replicated(state.v, mesh)
    return tuple(fetch_state(state, mesh))


def time_ode_chunk(mesh, device, fa, zeta: float, ode, steps: int, B: int, reps: int = 2):
    """Milliseconds a step of :func:`make_sharded_chunk_runner` on this mesh
    (on a clause mesh of the card: B6, B7 fused into its launches), from
    a random state of ``B`` rows: the host clock around ``reps`` chunks of
    ``steps`` steps, each ending in a device sync and a barrier, after one
    warm-up chunk. Rank 0's number comes back through
    ``parallel/launch.spawn``."""
    import time

    import torch.distributed as dist

    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.models.ode import formula_device, state_dtype

    rng = np.random.default_rng(5)
    v = rng.uniform(-1, 1, (B * mesh.n_traj, fa.n_vars_padded)).astype(np.float32)
    xs = np.broadcast_to(fa.xs_init, (v.shape[0], fa.n_clauses_padded)).astype(np.float32)
    state = state_from_numpy(v, xs, np.ones_like(xs), np.full(v.shape[0], 0.01, np.float32),
                             np.zeros(v.shape[0], bool), device=device)
    state, dev = shard_inputs(state, formula_device(fa, device, dtype=state_dtype(ode)), mesh)
    run = make_sharded_chunk_runner(fa, zeta, ode, steps, mesh, device)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()

    state = run(state, dev)  # a call consumes its input and returns it advanced
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        state = run(state, dev)
        sync()
    return (time.perf_counter() - t0) / (reps * steps) * 1e3


def fused_against_plain(mesh, device, fa: FormulaArrays, engine: str, fixed: bool = True,
                        steps: int = 1000, B: int = 64, seed: int = 0) -> tuple:
    """The clause chunk on this rank's card against its plain version, over
    this rank's clause group, from one random state: one chunk of ``steps``
    steps of B6 (``engine`` "ode"; fixed or adaptive, zeta of the paper
    gate) or B9 ("stoch"), through the kernels with no host sync between
    their launches (each reads the peers' slots after a stream wait: the
    race run), and through the plain version on the same card, whose
    partials travel over gloo.
    Returns ``(err, replicated)`` on every rank: the largest
    :func:`~odesat_tpu_torch.parallel.dist.bit_error` over the state and the
    ranks (0.0: bit for bit), and whether every clause rank's v holds the
    same bits."""
    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.models.ode import formula_device, state_dtype
    from odesat_tpu_torch.models.stoch import init_stoch_state
    from odesat_tpu_torch.ops.shard_chunk import make_shard_chunk
    from odesat_tpu_torch.ops.stoch_chunk import make_stoch_shard_chunk
    from odesat_tpu_torch.parallel.dist import bit_error
    from odesat_tpu_torch.utils.config import ODEConfig

    group = mesh.clause_group
    rng = np.random.default_rng(seed)
    Np, M = fa.n_vars_padded, fa.n_clauses_padded
    if engine == "ode":
        ode = ODEConfig(step_size=0.01 if fixed else None)
        zeta = ode.resolve_zeta(fa.density)
        xs = np.broadcast_to(fa.xs_init, (B, M)).astype(np.float32)
        arrays = (rng.uniform(-1, 1, (B, Np)).astype(np.float32), xs,
                  rng.uniform(1, 20, (B, M)).astype(np.float32), np.full(B, 0.01, np.float32),
                  rng.random(B) < 0.1)
        dev = formula_device(fa, "cpu", dtype=state_dtype(ode))
        state, _ = shard_inputs(state_from_numpy(*arrays, device="cpu"), dev, mesh)

        def run(plain):
            return make_shard_chunk(fa, zeta, ode, steps, group, device, plain)(
                type(state)(*(t.to(device, copy=True) for t in state)))
    else:
        state = init_stoch_state(fa, B, "cpu")
        state = shard_stoch_inputs(state._replace(v=torch.as_tensor(rng.random((B, Np)) < 0.5)),
                                   mesh)

        def run(plain):
            return make_stoch_shard_chunk(fa, steps, device, mesh.clause_index, group,
                                          plain=plain)(
                type(state)(*(t.to(device, copy=True) for t in state)), 12345)
    card = run(False)
    plain = run(True)
    err = max(bit_error(a.cpu().float(), b.cpu().float()) for a, b in zip(card, plain))
    copies = card.v.new_zeros((mesh.n_clause, *card.v.shape), dtype=torch.float32)
    copies[mesh.clause_index] = card.v.float()
    all_reduce(copies, group)
    same = all(torch.equal(copies[k], copies[0]) for k in range(mesh.n_clause))
    err = float(all_reduce(torch.tensor([err], dtype=torch.float64, device=device), group,
                           "max").item())
    return err, same

