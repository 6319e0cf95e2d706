"""The plain reference: the digital-memcomputing ODE (Bearden, Pei & Di
Ventra, arXiv:2011.06551; the upstream solver's ``src/system.rs``) in plain
PyTorch, integrated on rows of a batch, in float32.

It is a frozen copy of the arithmetic that ``odesat_tpu_torch/ops/
fused_chunk.py`` documents for its kernel B1 (``fused_chunk_plain``,
``_rhs_plain``, ``_update``; float32, no bfloat16 rounding): the same
operations in the same order, each variable's derivative summed over its
occurrences in (clause, slot) order in one running sum, so that a sound
kernel and this reference agree bit for bit. It runs on the benchmark's own
layout (``formulas.layout``) and imports nothing of the program.

Trajectories are independent rows (a fixed step, or a step size of each
row's own), so the reference integrates a sample of a solve's rows. On a
card a run of steps is captured once as a CUDA graph of these operations
and replayed: the same kernels, without the host's launch cost.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

ALPHA, BETA, GAMMA, DELTA, EPSILON = 5.0, 20.0, 0.25, 0.05, 1e-3
DT_INIT, DT_MIN, DT_MAX = 0.01, 2.0 ** -7, 1e3
INF = float("inf")


class State(NamedTuple):
    v: torch.Tensor  # (R, Np)
    xs: torch.Tensor  # (R, Mp)
    xl: torch.Tensor  # (R, Mp)
    dt: torch.Tensor  # (R,)
    done: torch.Tensor  # (R,) bool


def initial_v(seed: int, batch: int, Np: int, device) -> torch.Tensor:
    """The (batch, Np) initial values a solve seeded with ``seed`` draws:
    ``2u - 1``, u uniform from a ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((batch, Np), generator=gen, device=device, dtype=torch.float32)
    return 2.0 * u - 1.0


class Tables:
    """A layout's tables and numbers on ``device``, as tensors, so a step
    creates nothing from a Python number (what a graph capture needs). A
    second layout of the same shapes (``D`` padded to ``d``) is loaded in
    place (:meth:`load`), so a captured graph serves every formula of a
    family."""

    def __init__(self, lay, device, d: int | None = None):
        self.device = torch.device(device)
        self.K, self.Mp, self.Np = lay.K, lay.Mp, lay.Np
        self.d = max(d or 1, lay.occ.shape[1])
        dev, f32 = self.device, torch.float32

        def t(x):
            return torch.tensor(x, dtype=f32, device=dev)

        self.lit_var = torch.zeros((lay.K, lay.Mp), dtype=torch.int64, device=dev)
        self.negated = torch.zeros((lay.K, lay.Mp), dtype=torch.bool, device=dev)
        self.lit_on = torch.zeros((lay.K, lay.Mp), dtype=torch.bool, device=dev)
        self.clause_on = torch.zeros(lay.Mp, dtype=torch.bool, device=dev)
        self.xs_init = torch.zeros(lay.Mp, dtype=f32, device=dev)
        self.occ = torch.zeros((lay.Np, self.d), dtype=torch.int64, device=dev)
        self.zeta, self.xl_cap = t(0.0), t(0.0)
        self.zero, self.inf = t(0.0), t(INF)
        self.eps, self.one_eps, self.one, self.minus_one = t(EPSILON), t(1.0 - EPSILON), t(1.0), \
            t(-1.0)
        self.dt_min, self.dt_max = t(DT_MIN), t(DT_MAX)
        self.load(lay)

    def load(self, lay) -> None:
        if (lay.K, lay.Mp, lay.Np) != (self.K, self.Mp, self.Np) or lay.occ.shape[1] > self.d:
            raise ValueError("a layout of other shapes")
        occ = np.full((lay.Np, self.d), lay.K * lay.Mp, dtype=np.int64)
        occ[:, : lay.occ.shape[1]] = lay.occ
        for dst, src in ((self.lit_var, lay.lit_var), (self.negated, lay.negated),
                         (self.lit_on, lay.lit_on), (self.clause_on, lay.clause_on),
                         (self.xs_init, lay.xs_init), (self.occ, occ)):
            dst.copy_(torch.as_tensor(src))
        self.zeta.fill_(lay.zeta)
        self.xl_cap.fill_(lay.xl_cap)


def start(tab: Tables, v0: torch.Tensor) -> State:
    """The state a solve starts from: ``v0``, xs at the all-false clause
    valuation, xl = 1, dt = 0.01, nothing done."""
    R = v0.shape[0]
    return State(v0.to(tab.device, torch.float32).contiguous(),
                 tab.xs_init.expand(R, tab.Mp).clone(),
                 torch.ones((R, tab.Mp), dtype=torch.float32, device=tab.device),
                 torch.full((R,), DT_INIT, dtype=torch.float32, device=tab.device),
                 torch.zeros(R, dtype=torch.bool, device=tab.device))


def _clamp(x, lo, hi):
    return torch.fmin(torch.fmax(x, lo), hi)


def rhs(v, xs, xl, tab: Tables):
    """One right-hand side, with the paper's rigidity gate (the CLI's
    default): (dv, dxs, dxl, allsat)."""
    R = v.shape[0]
    g = v[:, tab.lit_var]  # (R, K, Mp)
    vals = torch.where(tab.lit_on, 1.0 - torch.where(tab.negated, -g, g), tab.inf)
    m1 = vals[:, 0]
    m2 = torch.full_like(m1, INF)
    for k in range(1, tab.K):  # the least and second least literal value
        m2 = torch.minimum(m2, torch.maximum(m1, vals[:, k]))
        m1 = torch.minimum(m1, vals[:, k])
    c = 0.5 * m1
    a = -0.5 * (xl * xs)
    b = (-0.5 * ((1.0 + tab.zeta * xl) * (1.0 - xs))).unsqueeze(1)
    A1 = (a * m1).unsqueeze(1)
    A2 = (a * m2).unsqueeze(1)
    is_min = vals <= m1.unsqueeze(1)
    cp = torch.where(is_min, A2 + b * vals, A1)
    contrib = torch.where(tab.lit_on, torch.where(tab.negated, cp, -cp), tab.zero)
    flat = torch.cat([contrib.reshape(R, -1), contrib.new_zeros(R, 1)], dim=1)
    picked = flat[:, tab.occ]  # (R, Np, D)
    dv = torch.zeros_like(v)
    for d in range(picked.shape[-1]):  # one running sum, in list order
        dv = dv + picked[:, :, d]
    on = tab.clause_on
    dxs = torch.where(on, BETA * (xs + EPSILON) * (c - GAMMA), tab.zero)
    dxl = torch.where(on, ALPHA * (c - DELTA), tab.zero)
    allsat = ((c < GAMMA) | ~on).all(dim=1)
    return dv, dxs, dxl, allsat


def _update(v, xs, xl, dv, dxs, dxl, dt_col, tab: Tables):
    xs2 = _clamp(xs + dt_col * dxs, tab.eps, tab.one_eps)
    xl2 = _clamp(xl + dt_col * dxl, tab.one, tab.xl_cap)
    v2 = _clamp(v + dt_col * dv, tab.minus_one, tab.one)
    return v2, xs2, xl2


class Integrator(NamedTuple):
    """How a solve integrates: ``dt`` (a fixed step) or None (each row's
    own step size, by step doubling to ``tol``)."""

    dt: float | None
    tol: float = 1e-3


def step(s: State, tab: Tables, how: Integrator, dt_fixed: torch.Tensor) -> State:
    """One step. Fixed: the update lands on the step that finds every
    clause satisfied, then the row freezes. Adaptive: a done or satisfied
    row is not advanced."""
    v, xs, xl, dt, done = s
    dv, dxs, dxl, allsat = rhs(v, xs, xl, tab)
    if how.dt is not None:
        dt_col = torch.where(done, tab.zero, dt_fixed).unsqueeze(1)
        v, xs, xl = _update(v, xs, xl, dv, dxs, dxl, dt_col, tab)
        return State(v, xs, xl, dt, done | allsat)
    advance = ~done & ~allsat
    dt_col = torch.where(advance, dt, tab.zero).unsqueeze(1)
    half = 0.5 * dt_col
    fv, fxs, fxl = _update(v, xs, xl, dv, dxs, dxl, dt_col, tab)
    hv, hxs, hxl = _update(v, xs, xl, dv, dxs, dxl, half, tab)
    dv2, dxs2, dxl2, _ = rhs(hv, hxs, hxl, tab)
    tv, txs, txl = _update(hv, hxs, hxl, dv2, dxs2, dxl2, half, tab)
    err = torch.maximum((fv - tv).abs().amax(dim=1),
                        torch.maximum((fxs - txs).abs().amax(dim=1),
                                      (fxl - txl).abs().amax(dim=1)))
    ratio = torch.full_like(err, how.tol) / err.clamp_min(1e-30)
    new_dt = _clamp(dt * torch.sqrt(ratio), tab.dt_min, tab.dt_max)
    adv = advance.unsqueeze(1)
    return State(torch.where(adv, tv, v), torch.where(adv, txs, xs), torch.where(adv, txl, xl),
                 torch.where(advance, new_dt, dt), done | allsat)


class Runner:
    """``group`` steps at a time from a state held in place: on a card one
    CUDA graph of the steps, captured at the first call and replayed; on the
    CPU the steps themselves."""

    def __init__(self, tab: Tables, how: Integrator, rows: int, group: int):
        self.tab, self.how, self.group = tab, how, group
        self.dt_fixed = torch.tensor(how.dt or 0.0, dtype=torch.float32, device=tab.device)
        self.state = start(tab, torch.zeros((rows, tab.Np), device=tab.device))
        self.graph = None

    def _steps(self, s: State, n: int) -> State:
        for _ in range(n):
            s = step(s, self.tab, self.how, self.dt_fixed)
        return s

    def set(self, s: State) -> None:
        for dst, src in zip(self.state, s):
            dst.copy_(src)

    def advance(self, n: int) -> None:
        """``n`` steps in place: whole groups by the graph, the rest as steps."""
        groups, rest = divmod(n, self.group)
        if self.tab.device.type == "cuda" and groups:
            if self.graph is None:
                self._capture()
            for _ in range(groups):
                self.graph.replay()
        elif groups:
            self.set(self._steps(self.state, groups * self.group))
        if rest:
            self.set(self._steps(self.state, rest))

    def _capture(self) -> None:
        keep = State(*(t.clone() for t in self.state))
        side = torch.cuda.Stream(self.tab.device)
        side.wait_stream(torch.cuda.current_stream(self.tab.device))
        with torch.cuda.stream(side):  # a warm step before capture, as torch asks
            self._steps(keep, 1)
        torch.cuda.current_stream(self.tab.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.set(self._steps(self.state, self.group))
        self.set(keep)  # the capture ran nothing; keep the state as it was
