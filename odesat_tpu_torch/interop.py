"""Carry formulas and solver states between this package and NumPy.

The port never imports jax; the tests hold it against the JAX package by
passing the same NumPy arrays to both. ``formula_arrays_from_numpy``
takes any object with the fields of ``FormulaArrays`` (the JAX package's
included) and ``state_from_numpy`` / ``state_to_numpy`` move an ODE
state in and out. The two packages' RNGs differ, so a parity run makes
its initial state with NumPy and hands it to both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from odesat_tpu_torch.cnf.arrays import FormulaArrays
from odesat_tpu_torch.models.ode import ODEState


def formula_arrays_from_numpy(fa) -> FormulaArrays:
    """The port's ``FormulaArrays`` holding copies of ``fa``'s arrays and
    its static fields (a JAX-package clause-shard plan is not carried: the
    port has no clause sharding yet)."""
    values = {}
    for f in dataclasses.fields(FormulaArrays):
        value = getattr(fa, f.name)
        values[f.name] = np.array(value) if isinstance(value, np.ndarray) else value
    return FormulaArrays(**values)


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
