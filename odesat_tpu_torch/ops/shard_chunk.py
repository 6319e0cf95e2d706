"""The clause-sharded ODE chunk (kernel B6): a hand-written CUDA kernel for
Hopper, its plain torch version and the chunk runner built on them.

Replaces the TPU kernel ``odesat_tpu/ops/shard_chunk.py::make_shard_chunk_call``
(Pallas; call :605). That kernel ran a whole chunk per launch with v, dt
and done resident in VMEM and did the clause-axis all-reduce of dv *inside*
the kernel, as a butterfly over ICI remote DMA (B7,
``odesat_tpu/ops/butterfly.py``). A CUDA kernel cannot wait on another rank,
so on Hopper the remote copies become a collective between launches
(``torch.distributed.all_reduce``, NCCL or gloo), and the chunk becomes a
sequence of launches of ``shard_chunk_launch`` (``csrc/stream_chunk.cu``)
with one all-reduce after each pass. Everything else the TPU kernel did
runs in those launches: each one first applies the previous launch's
reduced result to the trajectory (the v update and done latch; for the
adaptive integrator the commit, the step-doubling error and the dt
control), then runs the shard's next pass with B5's device code. A fixed
step is therefore one launch and one all-reduce with no torch operation
between them; an adaptive step is two launches and three all-reduces (dv1
with the sat count; dv2; the error with MAX); a chunk ends with one
apply-only launch.

Phases (:data:`PHASES`; buffers of :class:`ChunkBuffers`):

* ``step``: fixed; [apply] then the fixed pass: ``acc`` = (dv partial |
  1 - sat), xs and xl updated in place;
* ``apply``: fixed; apply only (the chunk's last launch);
* ``first``: adaptive; [commit] then pass 1: ``acc`` = (dv1 partial | 1 -
  sat), ``dxs1``/``dxl1`` staged;
* ``half``: adaptive; the half step ``hv`` from the reduced ``acc``, pass 2
  there: ``acc2`` = dv2 partial, ``err`` = the shard's error, xs and xl
  committed in place under the advance flag;
* ``commit``: adaptive; commit only (the chunk's last launch).

``done`` between launches is the done the last pass ran with: the next
launch latches the reduced sat count. The arithmetic is the per-step path's
(``ops/shard_stream.make_fused_clause_step``, B5), so B6 and B5 give the
same state bit for bit; the all-reduce returns the same bytes to every
rank, so ``v`` stays replicated (``parallel/sharded.check_replicated``
checks it).

What bounds it: device-memory bytes, as for B5 (v, xs and xl cross device
memory every step), plus the reduced (B, Np+1) buffer read back. The design
removes the torch operations B5's step ran on (B, Np) tensors between
launches (the v update, dt control and done latch), which cost about as
much as the kernel's own v traffic.

The plain version (:func:`shard_chunk_plain`) is the same phases in torch
ops over B5's plain versions. The wrappers launch the kernel for CUDA
tensors and the plain version for CPU tensors; anything else raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from odesat_tpu_torch.constants import DT_MAX, DT_MIN
from odesat_tpu_torch.ops.fused_chunk import _clamp, check_chunk_config
from odesat_tpu_torch.ops.shard_stream import (
    ShardSpec,
    shard_fixed_plain,
    shard_layout,
    shard_rhs_plain,
    shard_second_plain,
    shard_spec,
    stream_shard_supported,
)
from odesat_tpu_torch.ops.stream_chunk import kernel_threads, load_library, place_arg, raise_for

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
    power-of-two clause axis was its butterfly's need; the collective here
    takes any group."""
    return (stream_shard_supported(fa, plan, ode.dtype)
            and ode.dt_mode == "per-trajectory")


class ChunkBuffers(NamedTuple):
    """One rank's state and the chunk's staging, as the kernel reads them:
    v (B, Np), xs, xl (B, Mp) f32; dt (B,) f32; done (B,) bool; acc (B,
    Np+1) the pass's partial (dv | 1 - sat) and, once reduced, its sum;
    adaptive only: acc2 (B, Np) dv2, err (B,), dxs1, dxl1 (B, Mp). The
    fixed integrator reads no dt."""

    v: torch.Tensor
    xs: torch.Tensor
    xl: torch.Tensor
    dt: torch.Tensor
    done: torch.Tensor
    acc: torch.Tensor
    acc2: Optional[torch.Tensor] = None
    err: Optional[torch.Tensor] = None
    dxs1: Optional[torch.Tensor] = None
    dxl1: Optional[torch.Tensor] = None


# ---------------------------------------------------------------- plain


def _clamp_v(x):
    return _clamp(x, -1.0, 1.0)


def _dt_c(b: ChunkBuffers, spec: ShardSpec):
    """The step each row takes: 0 for done rows, else the fixed step or
    the row's dt."""
    return torch.where(b.done, 0.0, b.v.new_tensor(spec.dt_fixed) if spec.fixed else b.dt)


def _apply_plain(b: ChunkBuffers, spec: ShardSpec) -> ChunkBuffers:
    """The reduced result of the previous launch applied to v, dt, done."""
    Np = spec.Np
    dtc = _dt_c(b, spec).unsqueeze(1)
    dv1, allsat = b.acc[:, :Np], b.acc[:, Np] == 0
    if spec.fixed:
        return b._replace(v=_clamp_v(b.v + dtc * dv1), done=b.done | allsat)
    half = 0.5 * dtc
    adv = ~b.done & ~allsat
    fv = _clamp_v(b.v + dtc * dv1)
    tv = _clamp_v(_clamp_v(b.v + half * dv1) + half * b.acc2)
    err = torch.maximum(b.err, (fv - tv).abs().amax(dim=1))
    # a tensor numerator, since `float / tensor` rounds twice in torch
    new_dt = _clamp(b.dt * torch.sqrt(err.new_tensor(spec.tol) / err.clamp_min(1e-30)),
                    DT_MIN, DT_MAX)
    return b._replace(v=torch.where(adv.unsqueeze(1), tv, b.v), dt=torch.where(adv, new_dt, b.dt),
                      done=b.done | allsat)


def _flag(dv, sat):
    return torch.cat([dv, (~sat).to(dv.dtype).unsqueeze(1)], dim=1)


def shard_chunk_plain(phase: str, b: ChunkBuffers, spec: ShardSpec,
                      apply: bool = False) -> ChunkBuffers:
    """One launch of B6 in ``phase`` in torch ops; returns the buffers as
    the kernel leaves them."""
    if phase in ("apply", "commit") or (apply and phase in ("step", "first")):
        b = _apply_plain(b, spec)
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
    adv = ~b.done & (b.acc[:, Np] != 0)
    hv = _clamp_v(b.v + (0.5 * dtc).unsqueeze(1) * b.acc[:, :Np])
    dv2, xs, xl, err = shard_second_plain(hv, dtc, adv, b.xs, b.xl, b.dxs1, b.dxl1, spec)
    return b._replace(xs=xs, xl=xl, acc2=dv2, err=err)


# ---------------------------------------------------------------- kernel


def shard_chunk_cuda(phase: str, b: ChunkBuffers, spec: ShardSpec,
                     apply: bool = False) -> ChunkBuffers:
    """Launch B6 once in ``phase`` on the current stream; the buffers are
    updated in place and returned. Raises if a buffer is not what the
    kernel takes or the launch is refused; never falls back."""
    global launches
    if spec.device.type != "cuda":
        raise ValueError(f"the shard chunk kernel runs on CUDA tensors, not {spec.device}")
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}")
    B = b.v.shape[0]
    shapes = dict(v=(B, spec.Np), xs=(B, spec.Mp), xl=(B, spec.Mp), dt=(B,), done=(B,),
                  acc=(B, spec.Np + 1), acc2=(B, spec.Np), err=(B,), dxs1=(B, spec.Mp),
                  dxl1=(B, spec.Mp))
    for name, t in b._asdict().items():
        if t is None:
            if not spec.fixed:
                raise ValueError(f"the adaptive chunk needs the {name} buffer")
            continue
        dtype = torch.bool if name == "done" else torch.float32
        if (t.device != spec.device or tuple(t.shape) != shapes[name] or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}; the kernel "
                             f"takes a contiguous {shapes[name]} {dtype} on {spec.device}")
    if B == 0:
        return b
    layout = shard_layout(spec.Np, spec.Mp, not spec.fixed)
    scratch = torch.empty((B * layout.row_words) or 1, dtype=torch.float32, device=spec.device)
    lib, _ = load_library()

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.shard_chunk_launch(
            PHASES[phase], *(ptr(t) for t in b), spec.lit_code.data_ptr(),
            spec.occ_ptr.data_ptr(), spec.occ_code.data_ptr(), scratch.data_ptr(),
            place_arg(layout), layout.row_words, layout.smem_bytes, B, spec.Np, spec.Mp, spec.K,
            int(spec.paper), int(spec.bf16), kernel_threads(spec.Mp), spec.zeta,
            spec.dt_fixed or 0.0, spec.tol, spec.xl_cap, int(apply), stream,
        )
    raise_for(lib, rc, f"shard chunk kernel ({phase})")
    launches += 1
    return b


def shard_chunk_phase(phase: str, b: ChunkBuffers, spec: ShardSpec,
                      apply: bool = False) -> ChunkBuffers:
    """One launch in ``phase``: B6 for CUDA buffers, its plain version for
    CPU buffers."""
    kind = b.v.device.type
    if kind == "cuda":
        return shard_chunk_cuda(phase, b, spec, apply)
    if kind == "cpu":
        return shard_chunk_plain(phase, b, spec, apply)
    raise ValueError(f"no shard chunk path for tensors on {b.v.device}")


# ---------------------------------------------------------------- chunk


def make_shard_chunk(fa, zeta: float, ode, chunk_steps: int, clause_group=None,
                     device="cuda"):
    """``run(state, dev=None) -> state`` advancing this rank's trajectory
    rows ``chunk_steps`` steps over its clause segment (the JAX module's
    ``make_shard_chunk_call``, :158): B6's launches with the all-reduce
    over ``clause_group`` between them (none without a group, S=1). The
    shard is the rank's index in the group. The caller's state is never
    written."""
    import torch.distributed as dist

    from odesat_tpu_torch.models.ode import ODEState
    from odesat_tpu_torch.parallel.dist import all_reduce

    plan = fa.shard_plan
    if plan is None:
        raise ValueError("needs a compile_stream_sharded formula (shard plan)")
    check_chunk_config(ode, "clause-shard chunk kernel")
    if not shard_chunk_supported(fa, plan, ode):
        raise ValueError("the clause-shard chunk kernel needs a shard plan, no unit clauses, "
                         "float32 state, per-trajectory dt and v within one CTA")
    shard = 0
    if clause_group is not None:
        shard = dist.get_rank(clause_group)
        if dist.get_world_size(clause_group) != plan.n_shards:
            raise ValueError(f"the plan has {plan.n_shards} shards but the clause group "
                             f"{dist.get_world_size(clause_group)} ranks")
    spec = shard_spec(fa, zeta, ode, device, shard)

    def reduce(t, op="sum"):
        if clause_group is not None:
            all_reduce(t, clause_group, op)

    def run(state, dev=None):
        B, Np, Mp = state.v.shape[0], spec.Np, spec.Mp
        like = state.v
        b = ChunkBuffers(state.v.clone(), state.xs.clone(), state.xl.clone(), state.dt.clone(),
                         state.done.clone(), like.new_empty((B, Np + 1)))
        if not spec.fixed:
            b = b._replace(acc2=like.new_empty((B, Np)), err=like.new_empty((B,)),
                           dxs1=like.new_empty((B, Mp)), dxl1=like.new_empty((B, Mp)))
        for t in range(chunk_steps):
            if spec.fixed:
                b = shard_chunk_phase("step", b, spec, apply=t > 0)
                reduce(b.acc)
            else:
                b = shard_chunk_phase("first", b, spec, apply=t > 0)
                reduce(b.acc)
                b = shard_chunk_phase("half", b, spec)
                reduce(b.acc2)
                reduce(b.err, "max")
        if chunk_steps:
            b = shard_chunk_phase("apply" if spec.fixed else "commit", b, spec)
        return ODEState(b.v, b.xs, b.xl, b.dt, b.done)

    run.spec = spec
    return run
