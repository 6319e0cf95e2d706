"""graph_captures_per_solve.<cell>: the device loop's graphs instantiated
(``odesat_tpu_torch.ops.device_loop.captures``) over the window, a solve.
A program without the counter reads nothing."""

from bench_port import spans

COUNTERS = spans.present("odesat_tpu_torch.ops.device_loop:captures")


def read(ctx):
    if not COUNTERS:
        ctx.note("graph_captures_per_solve: the program counts no captures; not read")
        return None
    return ctx.counters[COUNTERS[0]] / len(ctx.records)
