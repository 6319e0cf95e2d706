"""The clause-sharded ODE chunk (kernel B6): a hand-written CUDA kernel for
Hopper, its plain torch version and the chunk runner built on them.

Replaces the TPU kernel ``odesat_tpu/ops/shard_chunk.py::make_shard_chunk_call``
(Pallas; call :605). That kernel ran a whole chunk per launch with v, dt
and done resident in VMEM and did the clause-axis all-reduce of dv *inside*
the kernel, as a butterfly over ICI remote DMA (B7,
``odesat_tpu/ops/butterfly.py``). On Hopper the ranks of a clause group are
processes, and the chunk becomes a sequence of launches of
``shard_chunk_launch`` (``csrc/stream_chunk.cu``), with the all-reduce
fused into the launches that consume it, as the TPU kernel combined its
partner's payload straight into its accumulator: every kernel of a launch
that reads a sum (the apply prologue, the head, the half step, the second
pass's advance flag) reads the S ranks' partials of the launch it consumes,
its own slot and the peers' IPC-mapped slots (``ops/butterfly.py``, after a
stream wait on their flags), and adds them in the butterfly's tree as it
reads them (``csrc/bfly_tree.cuh``). Everything else the TPU kernel did
runs in those launches too: each one first applies the previous launch's
result to the trajectory (the v update and done latch; for the adaptive
integrator the commit, the step-doubling error and the dt control), then
runs the shard's next pass with B5's arithmetic. A fixed step is one
launch, with no torch operation and no other launch beside it; an
adaptive step two, one for each invocation of the JAX butterfly (dv1 with
the sat count; dv2 with the error in a max zone); a chunk ends with one
apply-only launch.

A launch writes its partials ``acc``/``acc2`` into this launch's slot and
reads earlier launches' slots (the schedule of ``ops/butterfly.py``: a
fixed step needs K = 2 slots, an adaptive one 3, and every launch takes
its place on a ring of 3), so no rank writes a slot that a peer may still
read, and no reduced buffer exists; in a group of one a launch
reads its own partials, which are the sums.

Phases (:data:`PHASES`; buffers of :class:`ChunkBuffers`):

* ``step``: fixed; [apply] then the fixed pass: ``acc`` = (dv partial |
  1 - sat), xs and xl updated;
* ``apply``: fixed; apply only (the chunk's last launch);
* ``first``: adaptive; [commit] then pass 1: ``acc`` = (dv1 partial | 1 -
  sat), ``dxs1``/``dxl1`` staged;
* ``half``: adaptive; the half step ``hv`` from the first pass's summed
  dv1, pass 2 there: ``acc2`` = (dv2 partial | the shard's error), xs and xl committed
  under the advance flag;
* ``commit``: adaptive; commit only (the chunk's last launch).

``done`` between launches is the done the last pass ran with: the next
launch latches the reduced sat count. The arithmetic is the per-step path's
(``ops/shard_stream.make_fused_clause_step``, B5), so B6 and B5 give the
same state bit for bit; every rank adds the same partials in the same tree,
so ``v`` stays replicated (``parallel/sharded.check_replicated`` checks it).

Design for the card: the runner interleaves the chunk's buffers by tiles
of ``TILE`` = 32 trajectories (``ops/tiles.py``) once at entry and once
at exit, and every launch in between works on the tiled buffers (the sum
is elementwise). The kernels that read S partials in bulk take four
trajectories a thread, 16 bytes of each partial, so a warp reads whole
128-byte rows of each slot. A launch is a short sequence of
kernels over (tile, span of clauses or variables), with a tile's
trajectories on the lanes of a group: each table word is read once for 32
trajectories and each gather moves a whole 128-byte line; the clause words
m1, m2 are recomputed from ``v`` for every occurrence instead of being
stored, the clause side of a pass runs inside the variable pass, at each
clause's first occurrence, and nothing of a trajectory lives in shared
memory (``csrc/stream_chunk.cu``). The chunk's scratch, allocated once a
chunk (:func:`chunk_scratch`), is a second copy of xs and xl, into which a
pass writes the new clause memories while other occurrences still read
the old ones, and for the adaptive integrator the half step ``hv`` and an
error word a trajectory.

What bounds it: device-memory bytes, as for B5 (v, xs and xl cross device
memory every step), plus the S partials of (B, Np+1) read by the prologue.

The plain version (:func:`shard_chunk_plain`) is the same phases in torch
ops over B5's plain versions, in the ``(B, X)`` layout;
:func:`shard_chunk_phase` runs it on tiled CPU buffers by untiling them.
The wrappers launch the kernel for CUDA tensors and the plain version for
CPU tensors; anything else raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from odesat_tpu_torch.constants import DT_MAX, DT_MIN
from odesat_tpu_torch.ops import butterfly as bf
from odesat_tpu_torch.ops.fused_chunk import _clamp, check_chunk_config
from odesat_tpu_torch.ops.shard_stream import (
    ShardSpec,
    _flag,
    shard_fixed_plain,
    shard_rhs_plain,
    shard_second_plain,
    shard_spec,
    stream_shard_supported,
)
from odesat_tpu_torch.ops.stream_chunk import load_library, raise_for
from odesat_tpu_torch.ops.tiles import TILE, n_tiles, rows_of, tile, untile

# Kernel launches made through shard_chunk_cuda in this process (every
# phase). A plain integer that callers may reset; chip_smoke.py reads it.
launches = 0

PHASES = {"step": 0, "apply": 1, "first": 2, "half": 3, "commit": 4}


def resolve_shard_chunk(value, eligible: bool) -> bool:
    """Map an ``ODEConfig.shard_chunk`` value ('auto' | 'on' | 'off';
    legacy bools accepted) to a kernel choice: True runs the clause-sharded
    chunk (B6, or B9 for stoch), False the per-step path (B5, B8). 'auto'
    takes the chunk whenever the formula and config are eligible, as the
    JAX package's 'auto' does for the ODE (JAX :95-119); 'on' returns True
    and leaves the refusal of an ineligible run to the caller."""
    if isinstance(value, bool):
        value = "on" if value else "off"
    if value not in ("auto", "on", "off"):
        raise ValueError(f"shard_chunk must be 'auto', 'on' or 'off', got {value!r}")
    return value == "on" or (value == "auto" and eligible)


def shard_chunk_supported(fa, plan, ode) -> bool:
    """B6's gate: B5's (a shard plan, no unit clauses, f32 state, v in one
    CTA) and per-trajectory dt (JAX :146-155). The TPU kernel's
    power-of-two clause axis was its butterfly's need; B7 here takes any
    group."""
    return (stream_shard_supported(fa, plan, ode.dtype)
            and ode.dt_mode == "per-trajectory")


class ChunkBuffers(NamedTuple):
    """One rank's state and the chunk's staging: v (B, Np), xs, xl (B, Mp)
    f32; dt (B,) f32; done (B,) bool; acc (B, Np+1) the pass's partial (dv
    | 1 - sat); adaptive only: acc2 (B, Np+1) the second pass's (dv2 | the
    shard's step-doubling error), dxs1, dxl1 (B, Mp). The fixed integrator
    reads no dt. The plain version takes them in this layout, the kernel
    tiled (``ops/tiles.py``: (G, X, R) for (B, X), (G, R) for (B,)).

    A launch that consumes sums reads them from ``parts``, a pair ``(p1,
    p2)``: p1 the S ranks' partials (rank order) of the launch whose acc it
    consumes, p2 of the launch whose acc2 it consumes, each a list of
    tensors shaped as acc, combined in the butterfly's tree as they are read
    (p2's row Np by max); ``parts`` None, or either list None, reads the
    buffers' own acc, acc2 (a group of one: the partial is the sum)."""

    v: torch.Tensor
    xs: torch.Tensor
    xl: torch.Tensor
    dt: torch.Tensor
    done: torch.Tensor
    acc: torch.Tensor
    acc2: Optional[torch.Tensor] = None
    dxs1: Optional[torch.Tensor] = None
    dxl1: Optional[torch.Tensor] = None


# ---------------------------------------------------------------- plain


def _clamp_v(x):
    return _clamp(x, -1.0, 1.0)


def _dt_c(b: ChunkBuffers, spec: ShardSpec):
    """The step each row takes: 0 for done rows, else the fixed step or
    the row's dt."""
    return torch.where(b.done, 0.0, b.v.new_tensor(spec.dt_fixed) if spec.fixed else b.dt)


def _sums(b: ChunkBuffers, spec: ShardSpec, parts) -> tuple:
    """``(red, red2)``: the sums a launch reads, the partials of ``parts``
    combined in the butterfly's tree (red2's row Np by max), or the
    buffers' own acc, acc2 (see :class:`ChunkBuffers`)."""
    p1, p2 = (None, None) if parts is None else parts
    red = b.acc if p1 is None else bf.combine_parts(p1)
    red2 = b.acc2 if p2 is None else bf.combine_parts(p2, (spec.Np + 1, 1))
    return red, red2


def _apply_plain(b: ChunkBuffers, spec: ShardSpec, parts) -> ChunkBuffers:
    """The reduced result of the previous launches applied to v, dt, done."""
    Np = spec.Np
    red, red2 = _sums(b, spec, parts)
    dtc = _dt_c(b, spec).unsqueeze(1)
    dv1, allsat = red[:, :Np], red[:, Np] == 0
    if spec.fixed:
        return b._replace(v=_clamp_v(b.v + dtc * dv1), done=b.done | allsat)
    half = 0.5 * dtc
    adv = ~b.done & ~allsat
    fv = _clamp_v(b.v + dtc * dv1)
    tv = _clamp_v(_clamp_v(b.v + half * dv1) + half * red2[:, :Np])
    err = torch.maximum(red2[:, Np], (fv - tv).abs().amax(dim=1))
    # a tensor numerator, since `float / tensor` rounds twice in torch
    new_dt = _clamp(b.dt * torch.sqrt(err.new_tensor(spec.tol) / err.clamp_min(1e-30)),
                    DT_MIN, DT_MAX)
    return b._replace(v=torch.where(adv.unsqueeze(1), tv, b.v), dt=torch.where(adv, new_dt, b.dt),
                      done=b.done | allsat)


def shard_chunk_plain(phase: str, b: ChunkBuffers, spec: ShardSpec, apply: bool = False,
                      parts=None) -> ChunkBuffers:
    """One launch of B6 in ``phase`` in torch ops, reading the sums of
    ``parts`` (:class:`ChunkBuffers`); returns the buffers as the kernel
    leaves them."""
    if phase in ("apply", "commit") or (apply and phase in ("step", "first")):
        b = _apply_plain(b, spec, parts)
        if phase in ("apply", "commit"):
            return b
    dtc = _dt_c(b, spec)
    if phase == "step":
        dv, xs, xl, sat = shard_fixed_plain(b.v, dtc, b.xs, b.xl, spec)
        return b._replace(xs=xs, xl=xl, acc=_flag(dv, sat))
    if phase == "first":
        dv, dxs, dxl, sat = shard_rhs_plain(b.v, b.xs, b.xl, spec)
        return b._replace(acc=_flag(dv, sat), dxs1=dxs, dxl1=dxl)
    if phase != "half":
        raise ValueError(f"unknown phase {phase!r}")
    Np = spec.Np
    red = _sums(b, spec, parts)[0]
    adv = ~b.done & (red[:, Np] != 0)
    hv = _clamp_v(b.v + (0.5 * dtc).unsqueeze(1) * red[:, :Np])
    dv2, xs, xl, err = shard_second_plain(hv, dtc, adv, b.xs, b.xl, b.dxs1, b.dxl1, spec)
    return b._replace(xs=xs, xl=xl, acc2=torch.cat([dv2, err.unsqueeze(1)], dim=1))


def shard_chunk_plain_tiled(phase: str, b: ChunkBuffers, spec: ShardSpec, apply: bool = False,
                            parts=None) -> ChunkBuffers:
    """:func:`shard_chunk_plain` on tiled buffers and tiled partials:
    untiled (padding rows kept), run, tiled again."""
    R, rows = b.v.shape[-1], rows_of(b.v)

    def rowwise(ts):
        return None if ts is None else [untile(t, rows) for t in ts]

    out = shard_chunk_plain(phase, ChunkBuffers(*(None if t is None else untile(t, rows)
                                                  for t in b)), spec, apply,
                            None if parts is None else tuple(rowwise(p) for p in parts))
    return ChunkBuffers(*(None if t is None else tile(t, R) for t in out))


# ---------------------------------------------------------------- kernel


class ChunkScratch:
    """A chunk's scratch, allocated once a chunk (:func:`chunk_scratch`):
    the second copy of the clause memories xs2, xl2 (G, Mp, R) f32 into
    which ``step`` and ``half`` write the new ones (the launch swaps the
    copies), the shard's padded clauses ``pads`` (int32), and, adaptive
    only, the half step hv (G, Np, R) f32 and an error word a trajectory
    ``errbits`` (G, R) int32, zero between launches."""

    def __init__(self, xs2, xl2, pads, hv=None, errbits=None):
        self.xs2, self.xl2, self.pads, self.hv, self.errbits = xs2, xl2, pads, hv, errbits


def chunk_scratch(b: ChunkBuffers, spec: ShardSpec) -> ChunkScratch:
    """The scratch for tiled buffers ``b``."""
    scratch = ChunkScratch(torch.empty_like(b.xs), torch.empty_like(b.xl), spec.pads)
    if not spec.fixed:
        G, R = b.v.shape[0], b.v.shape[-1]
        scratch.hv = b.v.new_empty((G, spec.Np, R))
        scratch.errbits = torch.zeros((G, R), dtype=torch.int32, device=b.v.device)
    return scratch


def shard_chunk_cuda(phase: str, b: ChunkBuffers, spec: ShardSpec, apply: bool = False,
                     scratch: Optional[ChunkScratch] = None, parts=None) -> ChunkBuffers:
    """Launch B6 once in ``phase`` on the current stream, on tiled buffers
    (``TILE`` trajectories a tile), reading the sums of ``parts``
    (:class:`ChunkBuffers`: S tiled partials a list, the peers' slots on a
    clause mesh, which the launch's kernels add in the butterfly's tree as
    they read them); returns the buffers as the launch leaves them: updated
    in place, except that ``step`` and ``half`` return the new clause
    memories in the scratch's second copy and take the old ones into the
    scratch. ``scratch`` comes from :func:`chunk_scratch` (allocated here
    when None). Raises if a buffer is not what the kernel takes or the
    launch is refused; never falls back."""
    global launches
    if spec.device.type != "cuda":
        raise ValueError(f"the shard chunk kernel runs on CUDA tensors, not {spec.device}")
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}")
    G, R = b.v.shape[0], b.v.shape[-1]
    if R != TILE:
        raise ValueError(f"tiles of {R} trajectories; the kernel takes {TILE}")
    if scratch is None:
        scratch = chunk_scratch(b, spec)
    clause, sums = (G, spec.Mp, R), (G, spec.Np + 1, R)
    shapes = dict(v=(G, spec.Np, R), xs=clause, xl=clause, dt=(G, R), done=(G, R), acc=sums,
                  acc2=sums, dxs1=clause, dxl1=clause, xs2=clause, xl2=clause,
                  pads=tuple(scratch.pads.shape), hv=(G, spec.Np, R), errbits=(G, R))
    tensors = dict(b._asdict(), xs2=scratch.xs2, xl2=scratch.xl2, pads=scratch.pads,
                   hv=scratch.hv, errbits=scratch.errbits)
    for name, t in tensors.items():
        if t is None:
            if not spec.fixed:
                raise ValueError(f"the adaptive chunk needs the {name} buffer")
            continue
        dtype = {"done": torch.bool, "errbits": torch.int32, "pads": torch.int32}.get(
            name, torch.float32)
        if (t.device != spec.device or tuple(t.shape) != shapes[name] or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}; the kernel "
                             f"takes a contiguous {shapes[name]} {dtype} on {spec.device}")
    if G and {scratch.xs2.data_ptr(), scratch.xl2.data_ptr()} & {b.xs.data_ptr(),
                                                                  b.xl.data_ptr()}:
        raise ValueError("the scratch's clause memories are the buffers' own: pass the "
                         "buffers a launch returned")
    p1, p2 = (None, None) if parts is None else parts
    p1 = [b.acc] if p1 is None else list(p1)
    p2 = None if spec.fixed else [b.acc2] * len(p1) if p2 is None else list(p2)
    if p2 is not None and len(p2) != len(p1):
        raise ValueError(f"{len(p1)} and {len(p2)} partials: the two sums come from one group")
    red = bf.pointers(p1, sums, spec.device)
    red2 = None if p2 is None else bf.pointers(p2, sums, spec.device)
    if G == 0:
        return b
    lib, _ = load_library()

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.shard_chunk_launch(
            PHASES[phase], int(apply), *(ptr(t) for t in b[:5]), red, red2, len(p1),
            ptr(b.acc), ptr(b.acc2), ptr(b.dxs1), ptr(b.dxl1), scratch.xs2.data_ptr(),
            scratch.xl2.data_ptr(), ptr(scratch.hv), ptr(scratch.errbits),
            scratch.pads.data_ptr(), scratch.pads.numel(), spec.lit_code.data_ptr(),
            spec.occ_ptr.data_ptr(), spec.occ_code.data_ptr(), G, R, spec.Np, spec.Mp, spec.K,
            int(spec.paper), int(spec.bf16), spec.zeta, spec.dt_fixed or 0.0, spec.tol,
            spec.xl_cap, stream,
        )
    raise_for(lib, rc, f"shard chunk kernel ({phase})")
    launches += 1
    if len(p1) > 1:
        bf.fused_launches += 1
    if phase in ("step", "half"):
        old = b.xs, b.xl
        b = b._replace(xs=scratch.xs2, xl=scratch.xl2)
        scratch.xs2, scratch.xl2 = old
    return b


def shard_chunk_phase(phase: str, b: ChunkBuffers, spec: ShardSpec, apply: bool = False,
                      scratch: Optional[ChunkScratch] = None, parts=None) -> ChunkBuffers:
    """One launch in ``phase`` on tiled buffers, reading the sums of
    ``parts``: B6 for CUDA buffers, its plain version for CPU buffers."""
    kind = b.v.device.type
    if kind == "cuda":
        return shard_chunk_cuda(phase, b, spec, apply, scratch, parts)
    if kind == "cpu":
        return shard_chunk_plain_tiled(phase, b, spec, apply, parts)
    raise ValueError(f"no shard chunk path for tensors on {b.v.device}")


def tile_state(state, spec: ShardSpec) -> ChunkBuffers:
    """The chunk's tiled buffers for an ODE state of B rows: copies of v,
    xs, xl, dt and done, padded with done rows, and zeroed staging."""
    like = state.v
    G = n_tiles(like.shape[0])
    b = ChunkBuffers(tile(state.v), tile(state.xs), tile(state.xl, fill=1.0), tile(state.dt),
                     tile(state.done, fill=True), like.new_zeros((G, spec.Np + 1, TILE)))
    if not spec.fixed:
        b = b._replace(acc2=like.new_zeros((G, spec.Np + 1, TILE)),
                       dxs1=like.new_zeros((G, spec.Mp, TILE)),
                       dxl1=like.new_zeros((G, spec.Mp, TILE)))
    return b


# ---------------------------------------------------------------- chunk


def make_shard_chunk(fa, zeta: float, ode, chunk_steps: int, clause_group=None,
                     device="cuda", plain: bool = False):
    """``run(state, dev=None) -> state`` advancing this rank's trajectory
    rows ``chunk_steps`` steps over its clause segment (the JAX module's
    ``make_shard_chunk_call``, :158): B6's launches, each reading the S
    ranks' partials of the launches before it over ``clause_group``
    (``ops/butterfly.py``: on a card the peers' slots, after a stream wait on
    their flags; on the CPU the partials gathered over the group; in a group
    of one its own), on the rows tiled once at entry and untiled once at
    exit, with the scratch allocated once. ``plain``: the plain version on
    any device, the partials gathered over the group (what the card's runs
    are held against). The shard is the rank's index in the group. The
    caller's state is never written."""
    import torch.distributed as dist

    from odesat_tpu_torch.models.ode import ODEState

    plan = fa.shard_plan
    if plan is None:
        raise ValueError("needs a compile_stream_sharded formula (shard plan)")
    check_chunk_config(ode, "clause-shard chunk kernel")
    if not shard_chunk_supported(fa, plan, ode):
        raise ValueError("the clause-shard chunk kernel needs a shard plan, no unit clauses, "
                         "float32 state, per-trajectory dt and v within one CTA")
    shard, S = 0, 1
    if clause_group is not None:
        shard, S = dist.get_rank(clause_group), dist.get_world_size(clause_group)
        if S != plan.n_shards:
            raise ValueError(f"the plan has {plan.n_shards} shards but the clause group "
                             f"{S} ranks")
    spec = shard_spec(fa, zeta, ode, device, shard)

    def run(state, dev=None):
        B = state.v.shape[0]
        b = tile_state(state, spec)
        on_card = b.v.device.type == "cuda" and not plain
        scratch = chunk_scratch(b, spec) if on_card else None
        shape = tuple(b.acc.shape)
        comm = None
        if on_card and S > 1:
            comm = bf.communicator(clause_group, b.v.device)
            comm.begin(shape)

        def launch(b, phase, apply, parts, write=None):
            """One launch reading ``parts``; returns the buffers and the S
            partials (rank order) of the buffer ``write`` it wrote."""
            if comm is not None:
                comm.wait()  # the peers' earlier launches are done
                if write:  # the pass writes its partial into this launch's slot
                    b = b._replace(**{write: comm.slot(shape)})
            if on_card:
                b = shard_chunk_cuda(phase, b, spec, apply, scratch, parts)
            else:
                b = shard_chunk_plain_tiled(phase, b, spec, apply, parts)
            mine = None
            if comm is not None:
                mine = comm.parts(shape) if write else None
                comm.signal()
            elif write and S > 1:
                mine = [p.reshape(shape).to(b.v.device)
                        for p in bf.gather_plain(getattr(b, write), clause_group)]
            return b, mine

        p1 = p2 = None  # the partials of the last first (or step) and half launches
        for t in range(chunk_steps):
            if spec.fixed:
                b, p1 = launch(b, "step", t > 0, (p1, None), "acc")
            else:
                b, p1 = launch(b, "first", t > 0, (p1, p2), "acc")
                b, p2 = launch(b, "half", False, (p1, None), "acc2")
        if chunk_steps:
            b, _ = launch(b, "apply" if spec.fixed else "commit", False, (p1, p2))
        return ODEState(*(untile(t, B) for t in b[:5]))

    run.spec = spec
    return run
