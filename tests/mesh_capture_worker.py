"""A rank's half of tests/test_torch_mesh_capture.py's count of B7 calls,
for the ranks of a gloo world, which import this module and not the test
(it imports no jax)."""

from __future__ import annotations

from collections import Counter


def chunk_of(run):
    """The scan chunk (``ops/scan_chunk.ScanChunk``) a clause-mesh runner
    ran its last call through."""
    for name in ("chunks", "twins"):
        held = getattr(run, name, None)
        if held:
            last = list(held.values())[-1]
            return last[1] if isinstance(last, tuple) else last
    return run


def b7_calls_against_a_spy(mesh, device, cases):
    """For each ``(kind, fa, ode, B, steps)`` (``chip_smoke.mesh_case``):
    one chunk of the path on this rank with ``ops/butterfly.butterfly``
    wrapped to count its calls over groups of more than one rank, by group
    ("clause" or "traj"). Returns ``[(declared, counted), ...]``: the calls
    a chunk declares (``ScanChunk.b7_calls``) and those the spy counted."""
    import torch.distributed as dist

    import chip_smoke
    from odesat_tpu_torch.ops import butterfly

    def name(group):
        return "clause" if group is mesh.clause_group else "traj"

    out = []
    real = butterfly.butterfly
    for kind, fa, ode, B, steps in cases:
        make, state, dev = chip_smoke.mesh_case(mesh, device, kind, fa, ode, B, steps, 3)
        run = make()
        counted: Counter = Counter()

        def spy(t, group, zones=None, out=None):
            if group is not None and dist.get_world_size(group) > 1:
                counted[name(group)] += 1
            return real(t, group, zones, out)

        butterfly.butterfly = spy
        try:
            run(state, *(() if dev is None else (dev,)))
        finally:
            butterfly.butterfly = real
        declared = Counter(name(g) for g, _, _ in chunk_of(run).b7_calls(state))
        out.append((dict(declared), dict(counted)))
    return out
