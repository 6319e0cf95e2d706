"""Trajectory and clause parallelism on ``torch.distributed``: one rank per
process, spawned by the CLI (``launch``), joined into a ``(traj, clause)``
mesh (``mesh``) on one host or across the processes of a multi-host job
(``multihost``), with the host-side plumbing in ``dist`` and the sharded
runners in ``sharded``."""


from odesat_tpu_torch import lazy_exports

_D = "odesat_tpu_torch.parallel"
_EXPORTS = {
    **{name: f"{_D}.sharded:{name}" for name in (
        "compile_for_mesh", "make_sharded_chunk_runner", "make_sharded_stoch_runner",
        "shard_state", "simulate_batch_sharded")},
    "initialize_distributed": f"{_D}.multihost:initialize_distributed",
    "make_pod_mesh": f"{_D}.multihost:make_pod_mesh",
    "make_mesh": f"{_D}.mesh:make_mesh",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
