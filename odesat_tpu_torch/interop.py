"""Carry formulas and solver states between this package and NumPy.

The port never imports jax; the tests hold it against the JAX package by
passing the same NumPy arrays to both. ``formula_arrays_from_numpy``
takes any object with the fields of ``FormulaArrays`` (the JAX package's
included, a clause-shard plan too), ``state_from_numpy`` /
``state_to_numpy`` move an ODE state in and out, and
``stoch_state_from_numpy`` / ``stoch_state_to_numpy`` a stochastic-engine
state (the engine has no weights). ``rank_block`` cuts a global NumPy
array into one mesh rank's rows and clause segment. The two packages'
RNGs differ, so a parity run makes its initial state with NumPy and hands
it to both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays
from odesat_tpu_torch.models.ode import ODEState
from odesat_tpu_torch.models.stoch import StochState


def formula_arrays_from_numpy(fa) -> FormulaArrays:
    """The port's ``FormulaArrays`` holding copies of ``fa``'s arrays and
    its static fields. A clause-shard plan (the JAX package's
    ``StreamShardPlan`` or the port's) becomes the port's ``ShardPlan``,
    rebuilt from the arrays: the port's plan holds no planes."""
    from odesat_tpu_torch.ops.shard_stream import build_shard_plan

    values = {}
    for f in dataclasses.fields(FormulaArrays):
        value = getattr(fa, f.name, None)
        values[f.name] = np.array(value) if isinstance(value, np.ndarray) else value
    out = FormulaArrays(**{**values, "shard_plan": None})
    plan = getattr(fa, "shard_plan", None)
    if plan is not None:
        out = dataclasses.replace(out, shard_plan=build_shard_plan(
            out, plan.n_shards, getattr(plan, "clause_of", None)))
    return out


def rank_block(a, n_traj: int, n_clause: int, traj_index: int, clause_index: int,
               clause_sharded: bool = False):
    """Rank ``(traj_index, clause_index)``'s block of a global NumPy array of
    a ``n_traj x n_clause`` mesh: its rows, and with ``clause_sharded`` its
    segment of the second axis (what ``parallel/dist.local_block`` takes on
    the rank)."""
    a = np.asarray(a)
    rows = a.shape[0] // n_traj
    a = a[traj_index * rows:(traj_index + 1) * rows]
    if clause_sharded:
        per = a.shape[1] // n_clause
        a = a[:, clause_index * per:(clause_index + 1) * per]
    return a


def state_from_numpy(v, xs, xl, dt, done, device) -> ODEState:
    """An ODEState on ``device`` from NumPy arrays: v (B, Np), xs/xl
    (B, Mp), dt (B,) in the state dtype, done (B,) bool."""

    def put(a, dtype=None):
        t = torch.as_tensor(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype if dtype is not None else t.dtype).contiguous()

    v_t = put(v)
    return ODEState(
        v=v_t,
        xs=put(xs, v_t.dtype),
        xl=put(xl, v_t.dtype),
        dt=put(np.reshape(dt, -1), v_t.dtype),
        done=put(np.reshape(done, -1), torch.bool),
    )


def state_to_numpy(state) -> ODEState:
    """The same state with every field as a host NumPy array."""
    return ODEState(*(t.detach().cpu().numpy() for t in state))


def stoch_state_from_numpy(v, xl, done, device) -> StochState:
    """A StochState on ``device`` from NumPy arrays: v (B, Np) bool (or
    0/1), xl (B, Mp) integer weights, done (B,) bool. The JAX state's PRNG
    key has no counterpart: the port's runners carry their generator."""

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype).contiguous()

    return StochState(
        v=put(np.asarray(v).astype(bool), torch.bool),
        xl=put(np.asarray(xl).astype(np.int32), torch.int32),
        done=put(np.reshape(done, -1).astype(bool), torch.bool),
    )


def stoch_state_to_numpy(state) -> StochState:
    """The same state with every field as a host NumPy array."""
    return StochState(*(t.detach().cpu().numpy() for t in state))
