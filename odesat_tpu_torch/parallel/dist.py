"""Host-side plumbing of a mesh run: the port of
``odesat_tpu.parallel.dist``.

* :func:`local_rows` / :func:`local_block` take this rank's trajectory rows
  (and clause segment) of a global array: JAX's ``put_global``, which
  placed a host array on a sharding.
* :func:`fetch` collects every rank's rows (and segments) into one host
  array on EVERY rank. Choice: an all-reduce (SUM) of a zero-filled global
  buffer into which each rank writes its own block, on the tensor's own
  device. It is the one collective that every backend takes on every
  device: gloo gathers no CUDA tensors and NCCL no CPU tensors, but both
  all-reduce. A block is written by one rank only (clause rank 0 for what
  is replicated over the clause axis), so the sum is exact.
* :class:`MeshSync` makes the host loop's decisions global: the done flags
  every rank reads, the stop flag, and the elapsed time (all-reduced MAX),
  so every rank builds the same chunks and stops after the same one.
* :func:`mesh_reduce`: the torch twin's reductions inside a step
  (``models/ode.make_step_fn``): B7's standalone call (``ops/butterfly.py``:
  its kernel for CUDA tensors, its plain version for CPU ones) on a route
  "b7", ``torch.distributed`` on "dist", which a trajectory group over
  hosts takes (``parallel/sharded.twin_routes``) and the timings hold B7
  against.
* B7's checks and timings over a clause group (``ops/butterfly.py``, its
  standalone call): :func:`all_reduce_error` (the kernel against its plain
  version, bit for bit), :func:`butterfly_of`, :func:`time_butterfly`,
  :func:`time_butterfly_split` (where a call's time goes), and
  :func:`time_all_reduce`, the ``torch.distributed`` all-reduce B7
  replaced, kept as its yardstick.

The host's decisions stay on ``torch.distributed``; in JAX they are XLA
collectives outside any Pallas kernel. A twin step on a card within one
host makes no ``torch.distributed`` call: its sums and maxima run on B7.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def is_primary() -> bool:
    """True on the rank that prints and writes files, process 0's first
    rank (global rank 0), and in a process that joined no world on process
    0 of its pod (always without a pod): one writer on a shared
    filesystem."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    from odesat_tpu_torch.parallel.multihost import current_pod

    pod = current_pod()
    return pod is None or pod.process_id == 0


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """``t`` all-reduced in place over ``group`` (SUM or MAX); returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
    return t


def mesh_reduce(t: torch.Tensor, group, op: str = "sum", route: str = "b7") -> torch.Tensor:
    """``t`` reduced in place over ``group`` (SUM or MAX) and returned:
    through B7's standalone call on route "b7" (a max as the whole buffer
    one max zone, NaN propagating as in ``torch.maximum``), through
    :func:`all_reduce` on "dist"."""
    if route == "dist":
        return all_reduce(t, group, op)
    from odesat_tpu_torch.ops import butterfly as bf

    return bf.butterfly(t, group, None if op == "sum" else (t.numel(), t.numel()), t)


def row_block(n_local: int, mesh) -> slice:
    return slice(mesh.traj_index * n_local, (mesh.traj_index + 1) * n_local)


def local_rows(x, mesh):
    """This rank's block of trajectory rows of a global (B, ...) array."""
    B = x.shape[0]
    if B % mesh.n_traj:
        raise ValueError(f"{B} rows do not divide across {mesh.n_traj} trajectory ranks")
    return x[row_block(B // mesh.n_traj, mesh)]


def local_block(x, mesh):
    """This rank's rows and clause segment of a global (B, M) array."""
    rows = local_rows(x, mesh)
    M = rows.shape[1]
    if M % mesh.n_clause:
        raise ValueError(f"{M} clause columns do not divide across {mesh.n_clause} ranks")
    per = M // mesh.n_clause
    return rows[:, mesh.clause_index * per:(mesh.clause_index + 1) * per]


def fetch(x: torch.Tensor, mesh, clause_sharded: bool = False) -> np.ndarray:
    """The global array whose block on this rank is ``x``, as a host NumPy
    array on every rank (a collective: every rank calls it together).
    ``clause_sharded``: ``x`` is (B_local, M_local) of a clause-sharded
    array; otherwise its rows are replicated over the clause axis."""
    if mesh is None:
        return x.detach().cpu().numpy()
    kind = x.dtype
    work = x.detach().to(torch.int32) if kind == torch.bool else x.detach()
    B = work.shape[0]
    shape = [B * mesh.n_traj, *work.shape[1:]]
    if clause_sharded:
        shape[1] = work.shape[1] * mesh.n_clause
    buf = torch.zeros(shape, dtype=work.dtype, device=work.device)
    rows = row_block(B, mesh)
    if clause_sharded:
        n = work.shape[1]
        buf[rows, mesh.clause_index * n:(mesh.clause_index + 1) * n] = work
    elif mesh.clause_index == 0:
        buf[rows] = work
    all_reduce(buf)
    out = buf.cpu().numpy()
    return out.astype(bool) if kind == torch.bool else out


class MeshSync:
    """Global versions of the host loop's per-chunk decisions (models/loop.py)."""

    def __init__(self, mesh, device):
        self.mesh = mesh
        self.device = torch.device(device)

    def done(self, done: torch.Tensor) -> np.ndarray:
        """The global (B,) done flags on every rank."""
        return fetch(done, self.mesh)

    def any(self, done: torch.Tensor) -> bool:
        flag = done.any().to(torch.int32).reshape(1)
        return bool(all_reduce(flag, op="max").item())

    def all(self, done: torch.Tensor) -> bool:
        flag = (~done.all()).to(torch.int32).reshape(1)
        return not bool(all_reduce(flag, op="max").item())

    def max(self, x: float) -> float:
        return float(all_reduce(torch.tensor([x], dtype=torch.float64, device=self.device),
                                op="max").item())


def time_all_reduce(mesh, device, shape, iters: int = 10, dtype=torch.float32) -> float:
    """Milliseconds per ``torch.distributed`` all-reduce (SUM) of a
    ``dtype`` tensor of ``shape`` on this rank's device over its clause
    group: host clock around ``iters`` calls ending in a device sync, after one warm-up
    call; B7's ``library_ms``, the call it replaced. Rank 0's number comes
    back through ``parallel/launch.spawn``. With gloo and CUDA tensors each
    call is staged through the host."""
    import time

    t = torch.ones(shape, dtype=dtype, device=device)
    all_reduce(t, mesh.clause_group)

    def sync():
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        all_reduce(t, mesh.clause_group)
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def butterfly_of(mesh, device, parts, zones=None, dtype=np.float32) -> tuple:
    """B7 (:func:`~odesat_tpu_torch.ops.butterfly.butterfly`: the kernel on
    a card, the plain version on the CPU) over this rank's clause group of
    ``parts[k]`` on clause rank k (NumPy arrays cast to ``dtype``, float32
    or float64, one a rank; shapes or dtypes that differ make every rank
    raise). Returns ``(result, replicated)``: this rank's result as NumPy
    and whether every rank of the group got its bits."""
    from odesat_tpu_torch.ops import butterfly as bf

    group = mesh.clause_group
    mine = torch.as_tensor(np.ascontiguousarray(parts[dist.get_rank(group)], dtype))
    out = bf.butterfly(mine.to(device), group, zones).cpu()
    seen = [torch.empty_like(out) for _ in range(dist.get_world_size(group))]
    dist.all_gather(seen, out, group=group)
    same = all(torch.equal(_bits(s), _bits(out)) for s in seen)
    return out.numpy(), same


def butterfly_inputs(shape, S: int, calls: int, seed: int, device,
                     dtype=torch.float32) -> torch.Tensor:
    """(calls, S, *shape) partials of ``dtype`` for B7's checks, the same
    on every rank (drawn there from ``seed``): magnitudes from 1e-3 to 1e8
    and both signs, so that rank order and tree order round differently,
    with signed zeros and a few NaN. float64: magnitudes to 1e17, and
    infinities of both signs besides (the unit clauses' gradients)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = int(np.prod(shape))
    wide = dtype == torch.float64
    x = torch.rand((calls, S, n), generator=gen, device=device, dtype=dtype) - 0.5
    scale = torch.randint(-3, 18 if wide else 9, (calls, S, n), generator=gen,
                          device=device).to(dtype)
    x = x * torch.pow(10.0, scale)
    pick = torch.randint(0, 1000, (calls, S, n), generator=gen, device=device)
    x = torch.where(pick == 0, torch.full_like(x, float("nan")), x)
    x = torch.where(pick == 1, torch.zeros_like(x), x)
    x = torch.where(pick == 2, torch.full_like(x, -0.0), x)
    if wide:
        x = torch.where(pick == 3, torch.full_like(x, float("inf")), x)
        x = torch.where(pick == 4, torch.full_like(x, -float("inf")), x)
    return x.reshape(calls, S, *shape)


def bit_error(a: torch.Tensor, b: torch.Tensor) -> float:
    """0 where ``a`` and ``b`` (float32 or float64) hold the same bits,
    else their abs difference (inf where one is NaN): the max over the
    buffer. A NaN equals any NaN: IEEE leaves the payload of an arithmetic
    NaN to the hardware (the card gives 0x7fffffff, the CPU keeps an
    operand's)."""
    a, b = a.reshape(-1), b.reshape(-1)
    same = (_bits(a) == _bits(b)) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0.0
    diff = (a - b).abs()
    diff = torch.where(torch.isnan(diff), torch.full_like(diff, float("inf")), diff)
    return float(torch.where(same, torch.zeros_like(diff), diff).max())


def all_reduce_error(mesh, device, shape, seed: int = 0, zones=None, calls: int = 1,
                     dtype=torch.float32) -> float:
    """B7 against its plain version over this rank's clause group: ``calls``
    back-to-back calls of :func:`~odesat_tpu_torch.ops.butterfly.butterfly`
    (the kernel on a card), each on fresh ``dtype`` partials of ``shape``
    (:func:`butterfly_inputs`), with no host sync between them; then every
    call's result against the plain version's tree (``butterfly.combine``)
    of every rank's partial, and the first call's against
    :func:`~odesat_tpu_torch.ops.butterfly.butterfly_plain` itself. Returns
    the largest :func:`bit_error` over every call and every rank of the
    group (0.0: bit for bit)."""
    from odesat_tpu_torch.ops import butterfly as bf

    group = mesh.clause_group
    S, rank = dist.get_world_size(group), dist.get_rank(group)
    data = butterfly_inputs(shape, S, calls, seed, device, dtype)
    outs = torch.empty((calls, *shape), dtype=dtype, device=device)
    for c in range(calls):
        bf.butterfly(data[c, rank].contiguous(), group, zones, out=outs[c])
    worst = bit_error(bf.butterfly_plain(data[0, rank].contiguous(), group, zones), outs[0])
    for c in range(calls):
        want = bf.combine([data[c, k].reshape(-1) for k in range(S)], zones)
        worst = max(worst, bit_error(want, outs[c]))
    return float(all_reduce(torch.tensor([worst], dtype=torch.float64, device=device), group,
                            "max").item())


def time_butterfly(mesh, device, shape, iters: int = 20, plain_iters: int = 2,
                   dtype=torch.float32) -> tuple:
    """``(ms, plain_ms)`` a B7 call over this rank's clause group at a
    ``dtype`` ``shape``: the kernel's call (the flag write, the waits and the
    pass, on the slot as a chunk runner leaves it) and the plain version's,
    each on the host clock around its calls ending in a device sync and a
    barrier on every rank, after one warm-up call. Rank 0's numbers come
    back through ``parallel/launch.spawn``."""
    import time

    from odesat_tpu_torch.ops import butterfly as bf

    group = mesh.clause_group
    comm = bf.communicator(group, device)
    out = torch.empty(shape, dtype=dtype, device=device)

    def timed(call, n):
        call()
        torch.cuda.synchronize(device)
        dist.barrier(group=group)
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize(device)
        dist.barrier(group=group)
        return (time.perf_counter() - t0) / n * 1e3

    comm.begin(shape, dtype)
    ms = timed(lambda: comm.reduce(comm.slot(shape, dtype), None, out), iters)
    buf = torch.ones(shape, dtype=dtype, device=device)
    plain = timed(lambda: bf.butterfly_plain(buf, group), plain_iters)
    return ms, plain


def time_butterfly_split(mesh, device, shape, iters: int = 20) -> dict:
    """Where a standalone B7 call's time goes, over this rank's clause
    group at a float32 ``shape`` (ms a call; rank 0's numbers come back
    through ``parallel/launch.spawn``):

    * ``back_to_back``: calls one after another, as a runner makes them
      (host clock around ``iters`` calls ending in a sync and a barrier);
    * ``synced``: each call's flag raised, then a device sync and a host
      barrier on every rank, so that the wait is already satisfied; CUDA
      events around the wait and the kernel, every rank at once (the
      contexts still take turns on the card);
    * ``turns``: the same, one rank at a time while the others sit at a
      barrier (the card to itself);
    * ``alone``: the kernel alone (``tree_cuda``) on S buffers of rank 0's
      process while the others sit at a barrier, CUDA events around
      ``iters`` launches (rank 0's result only).

    ``back_to_back`` less ``synced`` is the wait for the peers' partials,
    ``synced`` less ``turns`` the sharing of the card between the ranks'
    contexts, ``turns`` less ``alone`` the stream operations' own cost."""
    import time

    from odesat_tpu_torch.ops import butterfly as bf

    group = mesh.clause_group
    S, rank = dist.get_world_size(group), dist.get_rank(group)
    comm = bf.communicator(group, device)
    comm.begin(shape)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    numel = int(np.prod(shape))
    stream = torch.cuda.current_stream(device)

    def settle():
        torch.cuda.synchronize(device)
        dist.barrier(group=group)

    def reduce():
        comm.reduce(comm.slot(shape), None, out)

    reduce()
    settle()
    t0 = time.perf_counter()
    for _ in range(iters):
        reduce()
    settle()
    result = {"back_to_back": (time.perf_counter() - t0) / iters * 1e3}

    def presynced(turn):
        """One call with the flag already raised everywhere: ms of its wait
        and kernel on this rank (CUDA events)."""
        i = comm.count % bf.SLOTS
        comm.signal()
        settle()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ms = None
        for r in range(S) if turn else (None,):
            if r is None or r == rank:
                start.record(stream)
                comm.wait()
                rc = comm.lib.bfly_tree(comm.slot_ptrs[i], S, out.data_ptr(), numel, numel, 0,
                                        comm.sms, stream.cuda_stream)
                bf._raise_for(comm.lib, rc, "kernel")
                end.record(stream)
                torch.cuda.synchronize(device)
                ms = start.elapsed_time(end)
            if turn:
                dist.barrier(group=group)
        settle()
        return ms

    for name, turn in (("synced", False), ("turns", True)):
        presynced(turn)
        result[name] = sum(presynced(turn) for _ in range(iters)) / iters
    if rank == 0:  # the others sit at the barrier: the card to itself
        local = [torch.ones(shape, dtype=torch.float32, device=device) for _ in range(S)]
        bf.tree_cuda(local, None, out)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(iters):
            bf.tree_cuda(local, None, out)
        end.record(stream)
        torch.cuda.synchronize(device)
        result["alone"] = start.elapsed_time(end) / iters
    settle()
    return result
