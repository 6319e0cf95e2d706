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
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def is_primary() -> bool:
    """True on the rank that prints and writes files (always without a
    world)."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """``t`` all-reduced in place over ``group`` (SUM or MAX); returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
    return t


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


def time_all_reduce(mesh, device, shape, iters: int = 10) -> float:
    """Milliseconds per all-reduce (SUM) of a float32 tensor of ``shape`` on
    this rank's device over its clause group: host clock around ``iters``
    calls ending in a device sync, after one warm-up call. Rank 0's number
    comes back through ``parallel/launch.spawn``. With gloo and CUDA
    tensors each call is staged through the host."""
    import time

    t = torch.ones(shape, dtype=torch.float32, device=device)
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


def all_reduce_error(mesh, device, shape, seed: int = 0) -> float:
    """B7 against its plain version: the max abs difference between the
    all-reduce (SUM) over this rank's clause group of a float32 buffer of
    ``shape`` drawn from ``(seed, rank)`` and the sum, in rank order, of
    every group rank's buffer drawn here."""
    ranks = dist.get_process_group_ranks(mesh.clause_group)

    def draw(rank):
        gen = torch.Generator().manual_seed(seed * 1000003 + rank)
        return torch.rand(shape, generator=gen).to(device)

    t = all_reduce(draw(dist.get_rank()), mesh.clause_group)
    plain = draw(ranks[0])
    for rank in ranks[1:]:
        plain = plain + draw(rank)
    return float((t - plain).abs().max())

