"""Solver configuration.

The port's copy of ``odesat_tpu.utils.config``: the same dataclasses
with the same fields and defaults, so a config written for one package
means the same run in the other. The reference keeps all knobs as clap
CLI flags and in-code constants (reference: src/main.rs:31-141,
src/system.rs:19-23,164-174); here they are dataclasses so library
users, the CLI, and tests share one config surface. Field names mirror
the reference flags (`-t` tolerance, `-n` steps, `-s` step_size, `-l`
learning_rate/zeta, `-r` ctv_ratio, `-b` batch_size).

``checkpoint_*``, ``resume_from`` and ``profile_dir`` work in every
engine (``utils/checkpoint.py``, ``models/loop.py``).
``ctv_ratio``/``preprocess`` drive the ``stoch``, ``solve`` and ``hybrid``
commands' preprocessing.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


def zeta_for_density(density: float) -> float:
    """Learning-rate table keyed on clause-to-variable density
    (reference: src/system.rs:164-173)."""
    if density >= 6.0:
        return 0.1
    if density >= 4.9:
        return 0.01
    return 0.001


@dataclass(frozen=True)
class ODEConfig:
    """Knobs of the ODE engine itself (reference layer L2)."""

    tolerance: float = 1e-3  # adaptive error tolerance (src/system.rs:174)
    step_size: Optional[float] = None  # fixed dt; None => adaptive (src/main.rs:49-51)
    steps: Optional[int] = None  # step budget; None => unbounded
    zeta: Optional[float] = None  # learning rate; None => density table
    rigidity: str = "paper"  # "paper" (argmin gate) | "reference" (exact-zero gate), SURVEY.md §2a
    dtype: str = "float32"  # "float32" | "float64" (reference is f64)
    # per-variable derivative accumulation:
    #   "auto"        - a CUDA chunk kernel (fused, then stream) for CUDA
    #                   f32 states one supports, else gather / segment_sum
    #   "gather"      - variable-major gather+sum (any formula, any device)
    #   "segment_sum" - scatter-add baseline
    #   "fused"       - the multi-step CUDA chunk kernel, state resident
    #                   in shared memory (ops/fused_chunk.py)
    #   "stream"      - the multi-step CUDA chunk kernel for formulas past
    #                   fused's gate, tables in L2 (ops/stream_chunk.py)
    #   "pallas"      - single steps through the CUDA RHS kernel
    #                   (ops/rhs_kernel.py); float32 or float64
    dv_strategy: str = "auto"
    # chunk-kernel rounding: "float32" (exact parity) or "bfloat16" (v is
    # rounded to bf16 before the literal values and the per-slot
    # contributions before the f32 dv sum, the TPU kernel's two rounding
    # points; trajectories diverge at ~1e-3 relative — solutions are
    # still oracle-verified)
    matmul_dtype: str = "float32"
    # adaptive-dt coupling across the trajectory batch:
    #   "per-trajectory" - each trajectory carries its own dt (the
    #                      paper's intent)
    #   "shared"         - one dt for the whole batch, adapted from the
    #                      max error norm over all trajectories — the
    #                      parallel analog of the reference inter mode's
    #                      single shared dt (src/system.rs:262-272,314)
    dt_mode: str = "per-trajectory"
    # clause mesh: "auto" runs the clause-sharded chunk kernels (B6 for the
    # ODE, B9 for stoch) where the formula and config are eligible, else
    # the per-step path; "on" forces them (raising when ineligible); "off"
    # takes the per-step kernels B5 and B8 (parallel/sharded.py)
    shard_chunk: str | bool = "auto"

    def resolve_zeta(self, density: float) -> float:
        return self.zeta if self.zeta is not None else zeta_for_density(density)


@dataclass(frozen=True)
class SolverConfig:
    """End-to-end solve configuration (CLI surface + runtime knobs)."""

    ode: ODEConfig = field(default_factory=ODEConfig)
    ctv_ratio: float = 7.0  # preprocessing target ratio (src/main.rs:150-154)
    preprocess: bool = True  # solve/stoch preprocess; batch/inter don't (src/main.rs:269,341)
    batch_size: int = 1  # trajectories per solve
    seed: Optional[int] = None  # None => nondeterministic (reference uses thread_rng)
    chunk_steps: int = 256  # Euler steps per kernel launch (early-exit granularity)
    var_pad: int = 128
    clause_pad: int = 128
    # width bucketing of the clause axis ("auto" | "on" | "off"): group
    # clauses by width so mixed-width formulas (preprocessing emits wide
    # resolvents) don't pay max clause width on every clause
    bucket: str = "auto"
    # order clauses (within width buckets) by lowest variable; an internal
    # layout choice kept so both packages compile the same arrays
    window_sort: bool = True
    checkpoint_path: Optional[str] = None  # optional state snapshot between chunks
    checkpoint_every_chunks: int = 0  # 0 => disabled
    resume_from: Optional[str] = None  # resume a solve from a snapshot (.npz)
    profile_dir: Optional[str] = None  # profiler trace output
    log_every_chunks: int = 0  # 0 => no periodic progress logs
    wall_clock_budget_s: Optional[float] = None  # stop unbounded runs after this

    def with_ode(self, **kwargs) -> "SolverConfig":
        return replace(self, ode=replace(self.ode, **kwargs))

    def wants_chunk_cadence(self) -> bool:
        """True when the user asked for per-chunk side effects at a fixed
        interval — checkpoint cadence (only live when a path is set; the
        save branch requires both) or periodic logging. Shared by the
        chunk-escalation gate and the multi-chunk loop gate
        (models/loop.py) so the two never drift."""
        return bool(
            (self.checkpoint_every_chunks and self.checkpoint_path)
            or self.log_every_chunks
        )
