"""The clause mesh's runners made to consume their input as a donated
buffer may be consumed, for tests/test_torch_donation.py: in the test's own
process (``monkeypatch.setattr``) and on the ranks of a gloo world, which
import this module and not the test (it imports no jax).

A clause-mesh runner (B6's ``make_shard_chunk``, B5's ``make_clause_chunk``,
B9's ``make_stoch_shard_chunk``, and ``make_clause_stoch_runner`` around
B8's and B9's routes) works in its input's own storage. The wrapped runner
runs on a copy instead and then fills every field of its input with NaN
(floats), -1 (integers) or True (bools): the other thing a donated input
may become. A caller that reads an input after the call then reads poison,
where with the runner as it is it would read the result.
"""

from __future__ import annotations

import numpy as np
import torch


def poison(state, out) -> int:
    """Fill every field of ``state`` that shares no memory with ``out``;
    returns how many."""
    kept = {t.untyped_storage().data_ptr() for t in out}
    n = 0
    for t in state:
        if t.numel() and t.untyped_storage().data_ptr() not in kept:
            t.fill_(float("nan") if t.is_floating_point() else
                    True if t.dtype == torch.bool else -1)
            n += 1
    return n


def _consuming(build, filled):
    def make(*a, **k):
        run = build(*a, **k)

        def consumed(state, *args):
            from odesat_tpu_torch.models.loop import copy_state

            out = run(copy_state(state), *args)
            filled["n"] += poison(state, out)
            return out

        consumed.__dict__.update(run.__dict__)
        return consumed

    return make


def consume_clause_runners(setattr_, filled) -> None:
    """Wrap the function that makes each clause-mesh runner through
    ``setattr_(module, name, value)``, counting the poisoned fields in
    ``filled["n"]``."""
    from odesat_tpu_torch.ops import shard_chunk, shard_stream, stoch_chunk
    from odesat_tpu_torch.parallel import sharded

    for mod, name in ((shard_chunk, "make_shard_chunk"), (shard_stream, "make_clause_chunk"),
                      (stoch_chunk, "make_stoch_shard_chunk"),
                      (sharded, "make_clause_stoch_runner")):
        setattr_(mod, name, _consuming(getattr(mod, name), filled))


def _same_start(setattr_, arrays, device):
    """``init_state`` hands out a copy of the NumPy state ``arrays``."""
    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.models import ode

    setattr_(ode, "init_state", lambda *a, **k: state_from_numpy(
        *(x.copy() for x in arrays), device=device))


def _simulate(mesh, device, setattr_, formula, config, arrays):
    from odesat_tpu_torch.parallel.sharded import simulate_batch_sharded

    _same_start(setattr_, arrays, device)
    return simulate_batch_sharded(formula, config, mesh, device=device)


def _stoch(mesh, device, setattr_, formula, config):
    from odesat_tpu_torch.models.stoch import search

    return search(formula, config, device=device, mesh=mesh)


def _hybrid(mesh, device, setattr_, formula, config):
    from odesat_tpu_torch.models.hybrid import hybrid_search

    return hybrid_search(formula, config, device=device, mesh=mesh)


RUNS = {"simulate": _simulate, "stoch": _stoch, "hybrid": _hybrid}


def mesh_run(mesh, device, what, consume, *args):
    """``RUNS[what](mesh, device, setattr_, *args)`` on every rank of a
    world (``parallel/launch.run_all``), with the clause-mesh runners
    consuming their inputs when ``consume``; every change undone after.
    Returns ``(result, fields poisoned on this rank)``."""
    undo = []

    def setattr_(mod, name, value):
        undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    filled = {"n": 0}
    if consume:
        consume_clause_runners(setattr_, filled)
    try:
        out = RUNS[what](mesh, device, setattr_, *args)
    finally:
        for mod, name, old in reversed(undo):
            setattr(mod, name, old)
    return out, filled["n"]


def snapshot(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}
