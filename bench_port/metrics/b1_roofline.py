"""b1_roofline.<cell>: kernel B1's share (%) of its roofline over the
traced window: the least time the card could take for the work B1 did
(``counts.ode_chunk_bound``: the rows, the steps the solves ran, the
state and tables moved once a chunk) over B1's device time in the trace.
B1 is the resident chunk kernel, ``lanes_chunk_kernel<true, ...>`` of
``odesat_tpu_torch/csrc/ode_lanes.cuh``. The trace's B1 launches must
equal the program's own count (``ops/fused_chunk.launches``), or the trace
missed some and nothing is read."""

from bench_port import counts

COUNTERS = ("odesat_tpu_torch.ops.fused_chunk:launches",)
B1 = r"lanes_chunk_kernel<true\b"


def read(ctx):
    if ctx.trace is None:
        return None
    n, seconds = ctx.trace.kernels(B1)
    if n == 0 or seconds <= 0.0 or n != ctx.counters[COUNTERS[0]]:
        ctx.note(f"b1_roofline: {n} B1 launches in the trace, "
                 f"{ctx.counters[COUNTERS[0]]} counted; not read")
        return None
    s = ctx.shapes
    steps = sum(r.steps for r in ctx.records) / n  # a chunk's steps, on the mean
    t, by = counts.ode_chunk_bound(s["K"], s["Mp"], s["Np"], s["nnz"], s["B"], steps, s["fixed"])
    ctx.note(f"b1_roofline: {n} launches, {seconds:.6f} s on the card, bound "
             f"{n * t:.6f} s by {by}")
    return 100.0 * n * t / seconds
