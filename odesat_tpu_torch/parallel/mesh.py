"""The ``(traj, clause)`` mesh over an initialized ``torch.distributed``
world: the port of ``odesat_tpu.parallel.mesh.make_mesh``.

Rank ``r`` sits at ``(r // S, r % S)`` of a ``T x S`` grid. The ranks of one
trajectory row share a block of trajectories and split its clause axis:
they form the row's *clause group*, over which the dv partials (ODE) and
the weight sums (stoch) are all-reduced every step. The ranks of one clause
column form its *traj group*. ``shape`` reads as JAX's ``mesh.shape``.
"""

from __future__ import annotations

import torch.distributed as dist


class Mesh:
    """This rank's place in a ``n_traj x n_clause`` mesh and its groups.
    Every rank must build it, in the same order: ``new_group`` is
    collective."""

    def __init__(self, n_traj: int, n_clause: int):
        world = dist.get_world_size()
        if n_traj * n_clause != world:
            raise ValueError(f"mesh {n_traj}x{n_clause} does not match a world of {world}")
        self.rank = dist.get_rank()
        self.traj_index, self.clause_index = divmod(self.rank, n_clause)
        self.shape = {"traj": n_traj, "clause": n_clause}
        self.clause_group = self.traj_group = None
        for t in range(n_traj):
            group = dist.new_group([t * n_clause + c for c in range(n_clause)])
            if t == self.traj_index:
                self.clause_group = group
        for c in range(n_clause):
            group = dist.new_group([t * n_clause + c for t in range(n_traj)])
            if c == self.clause_index:
                self.traj_group = group

    @property
    def n_traj(self) -> int:
        return self.shape["traj"]

    @property
    def n_clause(self) -> int:
        return self.shape["clause"]

    def __repr__(self) -> str:
        return (f"Mesh(traj={self.n_traj}, clause={self.n_clause}, rank {self.rank} at "
                f"({self.traj_index}, {self.clause_index}))")
