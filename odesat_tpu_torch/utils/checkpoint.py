"""Solver-state checkpointing: the port of ``odesat_tpu.utils.checkpoint``.

The same ``.npz`` snapshots with the same keys: ``field_<name>`` and
``fields`` for one engine, ``ode_<name>``/``stoch_<name>`` with
``ode_fields``/``stoch_fields`` for the hybrid, ``steps``, and the
``(traj, clause)`` ``mesh_layout``. ``ODEState`` has the same fields in
both packages, so ODE snapshots load in either.

The stochastic engines' randomness differs by design. The JAX state
carries a PRNG key; the port's ``StochState`` has none, and its runners
draw from CPU ``torch.Generator``s (``models/stoch.py``). A port stoch or
hybrid snapshot stores those generators' states beside the fields, one row
of ``rng_cpu`` (and, for the scan twin's device generator, ``rng_device``)
for each trajectory row of the mesh, so that a resumed run draws what the
uninterrupted run would have. JAX's ``load_state`` refuses such a snapshot
(its field list lacks ``key``), and :func:`load_state` refuses a JAX stoch
snapshot, since the two packages' random streams differ.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

RNG_KEYS = ("rng_cpu", "rng_device")


def _atomic_savez(path: str, arrays: dict) -> None:
    """Write an .npz atomically (tmp file + rename)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def mesh_layout_of(mesh) -> tuple:
    """(n_traj, n_clause) of a ('traj', 'clause') mesh; (1, 1) for none."""
    if mesh is None:
        return (1, 1)
    return (mesh.shape.get("traj", 1), mesh.shape.get("clause", 1))


def validate_mesh_layout(
    saved, mesh, what: str = "snapshot", traj_sensitive: bool = True
) -> None:
    """Reject a resume whose mesh layout differs from the snapshot's.

    The clause axis changes the compiled formula layout itself
    (``compile_for_mesh`` reorders and re-pads clauses for the shard plan),
    so a mismatched resume would feed clause memories in the wrong order.
    ``saved`` is None for snapshots written before layouts were recorded.

    ``traj_sensitive=False`` (ODE resumes): the trajectory axis is plain
    data parallelism and never reorders state, so an ODE snapshot may
    reshard onto another ``--devices`` count; only the clause component is
    enforced. A stoch or hybrid snapshot holds one generator state per
    trajectory row, so those keep the full check."""
    if saved is None:
        return
    cur = mesh_layout_of(mesh)
    saved = (int(saved[0]), int(saved[1]))
    if (traj_sensitive and saved != cur) or saved[1] != cur[1]:
        axes = "" if traj_sensitive else " clause axis of the"
        raise ValueError(
            f"cannot resume this {what}: it was taken on a "
            f"(traj={saved[0]}, clause={saved[1]}) mesh but this run uses "
            f"(traj={cur[0]}, clause={cur[1]}); resume with the same"
            f"{axes} --devices/--clause-shards layout"
        )


def _fetch_fields(state, mesh) -> dict:
    """Every field of a rank's state as the global host array (a collective
    on a mesh: every rank calls it); xs/xl are clause-sharded there."""
    from odesat_tpu_torch.parallel.dist import fetch

    return {name: fetch(value, mesh, clause_sharded=name in ("xs", "xl"))
            for name, value in state._asdict().items()}


def _write(path: str, arrays: dict, steps: int, mesh_layout, extra) -> None:
    from odesat_tpu_torch.parallel.dist import is_primary

    arrays["steps"] = np.asarray(steps)
    if mesh_layout is not None:
        arrays["mesh_layout"] = np.asarray(mesh_layout)
    arrays.update(extra or {})
    if is_primary():
        _atomic_savez(path, arrays)


def save_state(path: str, state, steps: int, mesh_layout=None, mesh=None,
               extra: dict | None = None) -> None:
    """Atomically snapshot a solver state NamedTuple (ODEState or
    StochState) plus the step counter. On a mesh (``mesh``) every rank
    gathers the global state (a collective: all must call) and rank 0
    writes the file. ``extra`` holds further arrays (the stoch engine's
    generator states)."""
    arrays = {f"field_{k}": v for k, v in _fetch_fields(state, mesh).items()}
    arrays["fields"] = np.asarray(list(state._fields))
    _write(path, arrays, steps, mesh_layout, extra)


def _refuse_jax_stoch(path: str, fields, cls) -> None:
    if "key" in fields and "key" not in cls._fields:
        raise ValueError(
            f"{path} holds a JAX package stoch state (its PRNG key): the two packages' random "
            "streams differ, so odesat_tpu_torch cannot continue it; resume it with "
            "odesat_tpu, the package that wrote it"
        )


def load_generator_states(path: str) -> dict:
    """The generator states a port stoch or hybrid snapshot holds
    (``rng_cpu``, and ``rng_device`` for the scan twin); empty for others."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in RNG_KEYS if k in data}


def load_state(path: str, state_cls):
    """Load a snapshot back into ``state_cls`` (ODEState or StochState).
    Returns (state, steps, mesh_layout) — mesh_layout is None for
    snapshots written before layouts were recorded."""
    with np.load(path, allow_pickle=False) as data:
        if "fields" not in data:
            kind = "hybrid" if "ode_fields" in data else "unrecognized"
            raise ValueError(
                f"{path} is a {kind} snapshot, not a single-engine one; "
                "resume it with the mode that wrote it"
            )
        fields = [str(f) for f in data["fields"]]
        _refuse_jax_stoch(path, fields, state_cls)
        if fields != list(state_cls._fields):
            raise ValueError(
                f"{path} holds a snapshot with fields {fields}, which do "
                f"not match {state_cls.__name__}{list(state_cls._fields)}; "
                "resume it with the engine that wrote it"
            )
        values = [data[f"field_{name}"] for name in fields]
        steps = int(data["steps"])
        layout = tuple(data["mesh_layout"]) if "mesh_layout" in data else None
    return state_cls(*values), steps, layout


def save_hybrid_state(path: str, ode_state, stoch_state, steps: int, mesh_layout=None,
                      mesh=None, extra: dict | None = None) -> None:
    """Snapshot the hybrid portfolio's two engine states into one file
    (field keys prefixed per engine; mesh semantics as :func:`save_state`)."""
    arrays = {f"ode_{k}": v for k, v in _fetch_fields(ode_state, mesh).items()}
    arrays.update({f"stoch_{k}": v for k, v in _fetch_fields(stoch_state, mesh).items()})
    arrays["ode_fields"] = np.asarray(list(ode_state._fields))
    arrays["stoch_fields"] = np.asarray(list(stoch_state._fields))
    _write(path, arrays, steps, mesh_layout, extra)


def load_hybrid_state(path: str, ode_cls, stoch_cls):
    """Load a hybrid snapshot. Returns (ode_state, stoch_state, steps,
    mesh_layout) — mesh_layout is None for pre-layout snapshots."""
    with np.load(path, allow_pickle=False) as data:
        if "ode_fields" not in data:
            raise ValueError(
                f"{path} is a single-engine snapshot, not a hybrid one"
            )
        # the fields-vs-class check load_state does: a cross-version or
        # corrupted file fails with this message, not a raw KeyError
        for key, cls in (("ode_fields", ode_cls), ("stoch_fields", stoch_cls)):
            fields = [str(f) for f in data[key]]
            _refuse_jax_stoch(path, fields, cls)
            if fields != list(cls._fields):
                raise ValueError(
                    f"{path} holds a hybrid snapshot whose {key} {fields} "
                    f"do not match {cls.__name__}{list(cls._fields)}; "
                    "resume it with the engine version that wrote it"
                )
        ode = ode_cls(*[data[f"ode_{f}"] for f in (str(x) for x in data["ode_fields"])])
        stoch = stoch_cls(
            *[data[f"stoch_{f}"] for f in (str(x) for x in data["stoch_fields"])]
        )
        steps = int(data["steps"])
        layout = tuple(data["mesh_layout"]) if "mesh_layout" in data else None
    return ode, stoch, steps, layout
