"""Mesh-sharded solve paths on ``torch.distributed``: the port of
``odesat_tpu.parallel.sharded``.

Two axes, as in the JAX package (the reference has neither):

* ``traj``: the trajectory (chain) batch splits over ranks as pure data
  parallelism. Each rank runs the single-device ladder on its rows (B1,
  then B2, then the twin; for stoch B3, then B4, then the twin); the only
  traffic is the host loop's per-chunk done flags.
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

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays, compile_formula
from odesat_tpu_torch.parallel.dist import (
    MeshSync,
    all_reduce,
    fetch,
    local_block,
    local_rows,
)
from odesat_tpu_torch.utils.logging import logger


def _n_clause(mesh) -> int:
    return 1 if mesh is None else mesh.n_clause


def _twin_on_card(device, what: str) -> None:
    """Say loudly that a clause mesh runs the torch twin on a card."""
    if torch.device(device).type == "cuda":
        logger.warning("clause mesh on %s runs the torch twin, not a kernel: %s", device, what)


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
        step = make_step_fn(fa, zeta, dataclasses.replace(
            ode, dv_strategy=resolve_strategy(fa, ode, device)), traj_group=mesh.traj_group)
        return _step_chunk(step, chunk_steps)

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
    step = make_step_fn(fa, zeta, ode, clause_group=mesh.clause_group,
                        traj_group=mesh.traj_group)
    return _step_chunk(step, chunk_steps)


def _step_chunk(step, chunk_steps):
    def run(state, dev):
        for _ in range(chunk_steps):
            state = step(state, dev)
        return state

    return run


def make_sharded_multi_runner(chunk, chunk_steps: int, max_chunks: int, mesh, device,
                              stop_on: str = "any"):
    """``run(state) -> (state, steps_advanced)``: up to ``max_chunks`` calls
    of ``chunk``, with the stop flag all-reduced over the world after every
    chunk, so every rank stops after the same one and ``steps_advanced`` is
    exact (JAX :332-414, :862-922), for either engine. It is the host loop
    of ``models/loop.run_chunks`` and takes any chunk runner, so the JAX
    package's eligibility probes (``sharded_multi_supported`` and its stoch
    twin, which gated an on-device loop) have no counterpart."""
    from odesat_tpu_torch.models.loop import run_chunks

    return run_chunks(chunk, chunk_steps, max_chunks, stop_all=stop_on == "all",
                      sync=MeshSync(mesh, device))


def check_replicated(v: torch.Tensor, mesh) -> None:
    """Raise unless ``v`` (float32 or bool) is bit-identical on every clause
    rank of this row: its bits all-reduced with MAX equal their MIN (the
    negation's MAX)."""
    if mesh is None or mesh.n_clause == 1:
        return
    x = v.detach().contiguous()
    bits = (x.view(torch.int32) if x.dtype == torch.float32 else x.to(torch.int32)).long()
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
    flip alike. Runnable at S=1 without a group."""
    import torch.distributed as dist

    from odesat_tpu_torch.models.stoch import (
        StochState,
        make_stoch_clause_eval,
        make_stoch_clause_step,
    )
    from odesat_tpu_torch.ops.shard_chunk import resolve_shard_chunk
    from odesat_tpu_torch.ops.stoch_chunk import (
        make_stoch_shard_chunk,
        make_stoch_shard_eval,
        stoch_shard_supported,
        traj_block,
        uniform01,
        uniform01_tiled,
    )
    from odesat_tpu_torch.ops.tiles import TILE, tile, untile

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

        return run_chunk
    Np = fa.n_vars_padded
    if not eligible:
        n = 1 if clause_group is None else dist.get_world_size(clause_group)
        step = make_stoch_clause_step(make_stoch_clause_eval(fa, device, shard, n).packed,
                                      clause_group)
        logger.info("stoch clause path -> twin clause evaluation on %s", device)
        _twin_on_card(device, "the stoch formula has no clause-shard plan")

        def run_twin(state):
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
            B = state.v.shape[0]
            chains = torch.arange(B, device=state.v.device, dtype=torch.int64)
            for t in range(chunk_steps):
                state = step(state, uniform01(seed, chains, traj_block(B), t, Np))
            return state

        return run_twin
    ev = make_stoch_shard_eval(fa, device, shard, matmul_dtype)
    logger.info("stoch clause path -> stoch_shard_eval (B8) on %s", device)

    def run(state):
        # the chains tiled once a chunk: B8's launches, the all-reduce, the
        # uniforms (drawn in tile order) and the flips all work on the tiles
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        B = state.v.shape[0]
        tiled = StochState(tile(state.v), tile(state.xl, fill=1), tile(state.done, fill=True))
        G = tiled.v.shape[0]
        acc = w = None
        if tiled.v.device.type == "cuda":  # B8's buffers, allocated once a chunk
            acc = torch.empty((G, 2 * Np + 1, TILE), dtype=torch.float32, device=tiled.v.device)
            w = torch.empty_like(tiled.xl)
        step = make_stoch_clause_step(lambda v, xl, done: ev.tiled(v, xl, done, acc, w),
                                      clause_group)
        for t in range(chunk_steps):
            u = uniform01_tiled(seed, G, traj_block(B), t, Np, tiled.v.device)
            tiled = step(tiled, u)
        return StochState(*(untile(x, B) for x in tiled))

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


# --------------------------------------------- runs for parity checks
#
# Module-level functions that parallel/launch.spawn can run on every rank:
# the tests and chip_smoke.py hold a mesh run against the same run on one
# device with them.


def run_ode_cases(mesh, device, cases):
    """For each ``(fa, zeta, ode, steps, arrays)``: shard the global NumPy
    state ``arrays`` (v, xs, xl, dt, done), run ``steps`` steps through
    :func:`make_sharded_chunk_runner` and return on rank 0 (None elsewhere)
    the global state as NumPy (v, xs, xl, dt, done) and, sixth, the final
    v of every clause rank of the first trajectory row, stacked."""
    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.models.ode import formula_device, state_dtype

    out = []
    for fa, zeta, ode, steps, arrays in cases:
        state = state_from_numpy(*arrays, device=device)
        dev = formula_device(fa, device, dtype=state_dtype(ode))
        state, dev = shard_inputs(state, dev, mesh)
        state = make_sharded_chunk_runner(fa, zeta, ode, steps, mesh, device)(state, dev)
        check_replicated(state.v, mesh)
        copies = state.v.new_zeros((mesh.n_clause, *state.v.shape))
        copies[mesh.clause_index] = state.v
        all_reduce(copies, mesh.clause_group)
        out.append((*fetch_state(state, mesh), copies.cpu().numpy()))
    return out if mesh.rank == 0 else None


def run_stoch_clause(mesh, device, fa, chunks: int, chunk_steps: int, seed: int,
                     matmul_dtype: str = "float32", batch: int = 8, shard_chunk="auto"):
    """``chunks`` chunks of the stoch clause path from the all-false start
    (no early stop), each row's generator from (seed, row), through B9
    (``shard_chunk`` 'auto') or B8 ('off'); returns the global (v, xl,
    done) as NumPy on rank 0. With ``mesh`` None it runs S=1 in this
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
    out = tuple(fetch_state(state, mesh))
    return out if mesh is None or mesh.rank == 0 else None


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

    run(state, dev)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        run(state, dev)
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
                type(state)(*(t.to(device) for t in state)))
    else:
        state = init_stoch_state(fa, B, "cpu")
        state = shard_stoch_inputs(state._replace(v=torch.as_tensor(rng.random((B, Np)) < 0.5)),
                                   mesh)

        def run(plain):
            return make_stoch_shard_chunk(fa, steps, device, mesh.clause_index, group,
                                          plain=plain)(
                type(state)(*(t.to(device) for t in state)), 12345)
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
