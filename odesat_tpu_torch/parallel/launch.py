"""Start the ranks of a ``T x S`` mesh: the torch counterpart of the JAX
package's single-controller process, where one process drove every device.

:func:`spawn` starts ``T*S`` worker processes with the ``spawn`` start
method (``fork`` after CUDA has been initialised breaks), each of which
joins the world (``multihost.initialize_distributed`` over a ``FileStore``
in a fresh temporary directory, so concurrent runs never share a store or
a port), builds the :class:`~odesat_tpu_torch.parallel.mesh.Mesh` and calls
``fn(mesh, device, *args)``. Rank 0's return value comes back to the
parent, with every rank's report of its kernel launch counts (for a
:func:`run_all` world, each call's own as well). A worker
that raises or exits non-zero, or a run that outlives ``timeout_s``, makes
the parent kill the others and raise.

The worker entry lives in this package, so that ``fn`` and its arguments
unpickle in a fresh interpreter anywhere the package imports. They travel
in a file in the run's temporary directory, not in the process's start-up
pipe: the parent's write into that pipe blocks until the child has read
it, and a child reads past the first pipe-full only once it has imported
torch, which takes seconds, so large arguments would start the ranks one
after another. Workers import no jax: each one checks. With
``device="cuda"`` the parent builds every CUDA source first, so that the
workers only load the libraries.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback

from odesat_tpu_torch.parallel.multihost import DEFAULT_TIMEOUT_S, check_backend

# Per-rank reports of the last spawn in this process (rank order): kernel
# launch counts, and after run_all each call's own under "calls".
# chip_smoke.py reads them.
last_reports: list = []
# This process's counts of its last run_all, one dict a call.
call_reports: list = []

_COUNTERS = (
    ("fused_chunk", "odesat_tpu_torch.ops.fused_chunk", "launches"),
    ("stream_chunk", "odesat_tpu_torch.ops.stream_chunk", "launches"),
    ("rhs", "odesat_tpu_torch.ops.rhs_kernel", "launches"),
    ("shard_stream", "odesat_tpu_torch.ops.shard_stream", "launches"),
    ("shard_chunk", "odesat_tpu_torch.ops.shard_chunk", "launches"),
    ("stoch_fused", "odesat_tpu_torch.ops.stoch_chunk", "fused_launches"),
    ("stoch_stream", "odesat_tpu_torch.ops.stoch_chunk", "stream_launches"),
    ("stoch_shard_eval", "odesat_tpu_torch.ops.stoch_chunk", "shard_launches"),
    ("stoch_shard_chunk", "odesat_tpu_torch.ops.stoch_chunk", "shard_chunk_launches"),
    ("butterfly", "odesat_tpu_torch.ops.butterfly", "launches"),
    ("butterfly_fused", "odesat_tpu_torch.ops.butterfly", "fused_launches"),
)
CUDA_SOURCES = ("fused_chunk", "stream_chunk", "stoch_chunk", "butterfly")


class WorkerError(RuntimeError):
    """A rank failed; the message holds its traceback."""


def _report() -> dict:
    import importlib

    return {name: getattr(importlib.import_module(mod), attr) for name, mod, attr in _COUNTERS}


def _zero_counts() -> None:
    import importlib

    for _, mod, attr in _COUNTERS:
        setattr(importlib.import_module(mod), attr, 0)


def _rank_report() -> dict:
    """A rank's launch counts; after run_all, summed over its calls, with
    each call's own under ``"calls"``."""
    if not call_reports:
        return _report()
    report = {name: sum(c[name] for c in call_reports) for name, _, _ in _COUNTERS}
    report["calls"] = list(call_reports)
    return report


def _worker(rank, world, n_clause, backend, device, store_path, timeout_s, payload, results):
    """One rank: read ``(fn, args)`` from the file ``payload``, join, build
    the mesh, run ``fn``, report, close B7's buffers (``ops/butterfly.py``),
    leave."""
    import torch.distributed as dist

    code = 0
    try:
        with open(payload, "rb") as fh:
            fn, args = pickle.load(fh)
        if device == "cpu":  # the ranks share the host's cores
            import torch

            torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // world)))
        if "jax" in sys.modules:
            raise RuntimeError("jax was imported in a worker")
        from odesat_tpu_torch.parallel.mesh import Mesh
        from odesat_tpu_torch.parallel.multihost import initialize_distributed

        dev = initialize_distributed(backend, device, rank=rank, world_size=world,
                                     store_path=store_path, timeout_s=timeout_s)
        mesh = Mesh(world // n_clause, n_clause)
        value = fn(mesh, dev, *args)
        if "jax" in sys.modules:
            raise RuntimeError("jax was imported in a worker")
        if "odesat_tpu_torch.ops.butterfly" in sys.modules:
            # B7's mappings close behind barriers before any rank frees or leaves
            sys.modules["odesat_tpu_torch.ops.butterfly"].close_all()
        results.put(("ok", rank, value if rank == 0 else None, _rank_report()))
    except Exception as e:  # noqa: BLE001 - the rank's failure goes back to the parent
        code = 1
        results.put(("error", rank, type(e).__name__, f"{e}\n{traceback.format_exc()}"))
    finally:
        if dist.is_available() and dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 - leaving anyway
                pass
    sys.exit(code)


def build_cuda_sources() -> None:
    """Build every CUDA source of the package (one nvcc each, at once)."""
    from concurrent.futures import ThreadPoolExecutor

    from odesat_tpu_torch.ops import _cuda

    with ThreadPoolExecutor(max_workers=len(CUDA_SOURCES)) as pool:
        list(pool.map(_cuda.build, CUDA_SOURCES))


def spawn(fn, n_traj: int, n_clause: int, backend: str = "nccl", device: str = "cuda",
          timeout_s: float | None = None, args: tuple = (),
          collective_timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run ``fn(mesh, device, *args)`` on every rank of a ``n_traj x
    n_clause`` world and return rank 0's value. ``fn`` must be importable
    from the package (a module-level function). ``timeout_s`` bounds the
    whole run (None: unbounded); ``collective_timeout_s`` each collective.
    Raises ValueError for what the backend cannot serve, and for a worker's
    ValueError (its message), WorkerError for any other failure."""
    global last_reports
    if n_traj < 1 or n_clause < 1:
        raise ValueError(f"a mesh needs at least one rank on each axis, not {n_traj}x{n_clause}")
    world = n_traj * n_clause
    check_backend(backend, device, world)
    if device == "cuda":
        build_cuda_sources()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="odesat_dist_")
    store_path = os.path.join(tmp, "store")
    payload = os.path.join(tmp, "payload.pkl")
    with open(payload, "wb") as fh:
        pickle.dump((fn, args), fh, protocol=pickle.HIGHEST_PROTOCOL)
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world, n_clause, backend, device, store_path,
                               collective_timeout_s, payload, results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        reports, value, error = {}, None, None
        t0 = time.monotonic()
        while len(reports) < world and error is None:
            try:
                msg = results.get(timeout=0.2)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    # a rank died without a word (killed, crashed): the
                    # others would wait in their next collective
                    try:
                        msg = results.get(timeout=1.0)
                    except queue.Empty:
                        error = ("WorkerError", f"rank {procs.index(dead[0])} exited "
                                 f"{dead[0].exitcode}")
                        break
                elif timeout_s is not None and time.monotonic() - t0 > timeout_s:
                    error = ("WorkerError", f"the run outlived its {timeout_s} s")
                    break
                else:
                    continue
            if msg[0] == "error":
                error = (msg[2], f"rank {msg[1]}: {msg[3]}")
            else:
                reports[msg[1]] = msg[3]
                if msg[1] == 0:
                    value = msg[2]
        if error is None:
            for p in procs:
                p.join(timeout=60)
            bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                error = ("WorkerError", f"ranks exited non-zero: {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        kind, text = error
        if kind == "ValueError":
            raise ValueError(text.splitlines()[0].split(": ", 1)[-1])
        raise WorkerError(f"{kind}: {text}")
    last_reports = [reports[r] for r in range(world)]
    return value


def run_all(mesh, device, calls):
    """``[fn(mesh, device, *args) for fn, args in calls]``: several runs in
    one world, which pays the ranks' start-up once. Every launch count is
    set to 0 before each call and read after it, into
    :data:`call_reports`, so that each call's launches are its own."""
    call_reports.clear()
    values = []
    for fn, args in calls:
        _zero_counts()
        values.append(fn(mesh, device, *args))
        call_reports.append(_report())
    return values


def on_mesh(mesh, device, shape, fn, *args):
    """``fn(Mesh(*shape), device, *args)``: a run on another ``(n_traj,
    n_clause)`` mesh of the same world, for :func:`run_all` (every rank
    builds it, in the same order)."""
    from odesat_tpu_torch.parallel.mesh import Mesh

    return fn(Mesh(*shape), device, *args)


def probe(mesh, device):
    """A rank's view of the world (rank 0's comes back): its place in the
    mesh, its device, and whether jax or the JAX package was imported."""
    return {
        "rank": mesh.rank, "shape": dict(mesh.shape), "device": str(device),
        "jax": "jax" in sys.modules,
        "odesat_tpu": any(m == "odesat_tpu" or m.startswith("odesat_tpu.") for m in sys.modules),
    }
