"""The ODE engine's workload: solves through ``odesat_tpu_torch.models.ode.
simulate_batch``, the entry point of the port's ``inter`` and ``batch``,
back to back from one client, and their check against the plain reference.

A solve is one call, as ``inter`` makes it (no preprocessing, the formula
normalized, the CLI's defaults unless the traffic names a value), with a
``torch.Generator`` on the card seeded from (``--seed``, the solve's
index). The solve's time runs from the call to the oracle's verdict on the
readouts of the rows the program reports done.

The check (after the window): a sample of the window's solves, drawn from
the seed as they come (a reservoir), and in each a sample of its rows with
every row the program reports done. The reference draws the same initial
values from the same generator, integrates those rows for the steps the
solve ran, and holds the program's readout, done flags and steps to its
own: the steps must be the first chunk boundary at which a sampled row is
done (with the stop rule ``any``), or the budget when none is.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench_port import formulas, reference

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def derived_seed(*words: int) -> int:
    """A 63-bit seed for (words...), the same on every machine; a negative
    word counts modulo 2**64."""
    entropy = [int(w) % (1 << 64) for w in words]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


@dataclass(eq=False)
class Record:
    """One solve: host-clock start and end, the steps it ran, whether a row
    was done and whether a done row's readout satisfies the formula; for a
    solve the reservoir keeps, the program's readout and done flags."""

    index: int
    t0: float
    t1: float
    steps: int
    rows: int
    solved: bool
    verified: bool
    seed: int = 0
    formula: int = 0
    loop_s: float = 0.0  # the entry point's own clock around its chunk loop
    assignment: np.ndarray | None = field(default=None, repr=False)
    done: np.ndarray | None = field(default=None, repr=False)


class Workload:
    def __init__(self, cell):
        self.cell = cell
        cfg, tr = cell.config, cell.traffic
        self.device = torch.device(cell.device)
        self.batch = int(tr["batch"])
        self.chunk = int(tr["chunk_steps"])
        self.budget = int(tr["steps"])
        self.stop_on = tr.get("stop_on", "any")
        if self.stop_on != "any":
            raise ValueError("the check holds a solve's steps to the stop rule 'any' only")
        self.witness = bool(tr.get("witness", False))
        spec = cfg["formula"]
        if spec["kind"] == "dimacs":
            with open(os.path.join(HERE, spec["path"]), encoding="utf-8") as fh:
                one = formulas.normalized(formulas.read_dimacs(fh.read()))
            self.family = formulas.Formula(one.var[None], one.neg[None], one.varnum)
            self.pick = lambda i: 0
        elif spec["kind"] == "planted_ksat":
            # the window's instances and, last, the warm-up's; a run never reuses one
            pool = int(tr["pool"])
            rng = np.random.default_rng(derived_seed(cell.seed, 1))
            self.family = formulas.planted_ksat(rng, pool + 1, spec["n"], spec["m"], spec["k"])
            self.pick = lambda i: i if 0 <= i < pool else (pool if i < 0 else None)
        else:
            raise ValueError(f"unknown formula kind {spec['kind']!r}")
        self.layout0 = formulas.layout(self.formula(0))
        from odesat_tpu_torch.cnf.formula import Literal
        from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig

        # the program's literals, one object each, so a request is built by
        # indexing (code 2*var + negated) rather than by constructing them
        n = self.family.varnum
        self.literals = np.empty(2 * n, dtype=object)
        self.literals[:] = [Literal(v, bool(g)) for v in range(n) for g in (0, 1)]

        if cfg["rigidity"] != "paper":
            raise ValueError("the reference integrates the paper's rigidity gate only")
        dt = tr.get("step_size")
        ode = dict(step_size=dt, steps=self.budget, tolerance=tr.get("tolerance", 1e-3),
                   rigidity=cfg["rigidity"], dtype=cfg["precision"]["dtype"],
                   matmul_dtype=cfg["precision"]["matmul_dtype"])
        ode.update(cell.overrides)
        self.ode = ODEConfig(**ode)
        self.config = SolverConfig(ode=self.ode, preprocess=False, batch_size=self.batch,
                                   chunk_steps=self.chunk)
        self.how = reference.Integrator(dt, float(self.ode.tolerance))

    def formula(self, i: int) -> formulas.Formula:
        return formulas.Formula(self.family.var[i], self.family.neg[i], self.family.varnum)

    def shapes(self) -> dict:
        lay = self.layout0
        return dict(K=lay.K, Mp=lay.Mp, Np=lay.Np, nnz=lay.nnz, B=self.batch,
                    chunk_steps=self.chunk, fixed=self.how.dt is not None)

    # ---------------------------------------------------------------- client

    def request(self, i: int):
        """Solve ``i``'s inputs, as a user holds them: the formula (the
        program's own type) and the solve's seed. ``i = -1`` is the
        warm-up's."""
        from odesat_tpu_torch.cnf.formula import CNFFormula

        j = self.pick(i)
        if j is None:
            raise RuntimeError(f"solve {i} has no instance left: the pool of "
                               f"{self.family.var.shape[0] - 1} is used up")
        f = self.formula(j)
        K = f.var.shape[1]
        lits = self.literals[(2 * f.var + f.neg).ravel()].tolist()
        clauses = [tuple(lits[r * K:r * K + w]) for r, w in enumerate(f.widths.tolist())]
        return i, j, derived_seed(self.cell.seed, 2, i), CNFFormula(clauses, f.varnum)

    def solve(self, req, keep: bool = False) -> Record:
        from odesat_tpu_torch.models.ode import simulate_batch

        i, j, seed, formula = req
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.perf_counter()
        res = simulate_batch(formula, self.config, device=self.device, generator=gen,
                             stop_on=self.stop_on)
        verified = res.solved_index is not None and bool(
            formulas.satisfied(self.formula(j), res.assignment[res.done]).any())
        t1 = time.perf_counter()
        rec = Record(i, t0, t1, int(res.steps), self.batch, res.solved_index is not None,
                     verified, seed, j, loop_s=res.wall_time_s)
        if keep:
            rec.assignment, rec.done = res.assignment, res.done
        return rec

    def warm(self) -> None:
        """One solve of the window's shapes on an instance and seed of its
        own."""
        self.solve(self.request(-1))

    def failed(self, rec: Record) -> bool:
        return (self.witness and not rec.verified) or (rec.solved and not rec.verified)

    # ----------------------------------------------------------------- check

    def check(self, kept: list) -> dict:
        """The numbers compared, each ``(value, limit)``: ``rows_off``, the
        largest share of a checked solve's sampled rows whose readout is
        not the reference's; ``done_off``, sampled rows whose done flag is
        not; ``steps_off``, checked solves whose steps are not."""
        limits = self.cell.traffic["limits"]
        rows = int(self.cell.traffic["check"]["rows"])
        n = self.family.varnum
        plans = []
        for rec in kept:
            rng = np.random.default_rng(derived_seed(self.cell.seed, 3, rec.index))
            pick = rng.choice(self.batch, size=min(rows, self.batch), replace=False)
            plans.append((rec, np.union1d(pick, np.flatnonzero(rec.done))))
        groups = {}
        for rec, idx in plans:
            groups.setdefault((rec.formula, rec.steps), []).append((rec, idx))
        lays = {j: formulas.layout(self.formula(j)) for j, _ in groups}
        d = max(lay.occ.shape[1] for lay in lays.values())
        tab = reference.Tables(self.layout0, self.device, d)
        width = max(sum(idx.size for _, idx in g) for g in groups.values())
        run = reference.Runner(tab, self.how, width, self.chunk)
        rows_off, done_off, steps_off = 0.0, 0, 0
        for (j, steps), group in groups.items():
            tab.load(lays[j])
            v0 = torch.cat([reference.initial_v(rec.seed, self.batch, tab.Np, self.device)[
                torch.as_tensor(idx, device=self.device)] for rec, idx in group])
            v0 = torch.cat([v0, v0[:1].expand(width - v0.shape[0], -1)])
            run.set(reference.start(tab, v0))
            firsts = [None] * len(group)  # the first chunk boundary with a done row
            at = 0
            while at < steps:
                n_steps = min(self.chunk, steps - at)
                run.advance(n_steps)
                at += n_steps
                done = run.state.done.cpu().numpy()
                o = 0
                for g, (rec, idx) in enumerate(group):
                    if firsts[g] is None and done[o:o + idx.size].any():
                        firsts[g] = at
                    o += idx.size
            v = run.state.v.cpu().numpy()
            done = run.state.done.cpu().numpy()
            o = 0
            for g, (rec, idx) in enumerate(group):
                ref_read = v[o:o + idx.size, :n] > 0.0
                ref_done = done[o:o + idx.size]
                o += idx.size
                differ = (ref_read != rec.assignment[idx]).any(axis=1)
                rows_off = max(rows_off, float(differ.mean()))
                done_off += int((ref_done != rec.done[idx]).sum())
                first = firsts[g]
                want = first if first is not None else self.budget
                steps_off += int(rec.steps != want or (first is None) == bool(rec.done.any()))
        return dict(rows_off=(rows_off, limits["rows_off"]),
                    done_off=(done_off, limits["done_off"]),
                    steps_off=(steps_off, limits["steps_off"]))
