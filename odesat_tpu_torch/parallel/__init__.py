"""Trajectory and clause parallelism on ``torch.distributed``: one rank per
process, spawned by the CLI (``launch``), joined into a ``(traj, clause)``
mesh (``mesh``), with the host-side plumbing in ``dist`` and the sharded
runners in ``sharded``."""
