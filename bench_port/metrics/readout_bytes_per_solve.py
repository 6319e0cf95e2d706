"""readout_bytes_per_solve.<cell>: the bytes the entry point's readouts
copied to the host (``odesat_tpu_torch.models.ode.readout_bytes``: the
assignment and the done flags, as fetched) over the window, a solve. A
program without the counter reads nothing."""

from bench_port import spans

COUNTERS = spans.present("odesat_tpu_torch.models.ode:readout_bytes")


def read(ctx):
    if not COUNTERS:
        ctx.note("readout_bytes_per_solve: the program counts no readout bytes; not read")
        return None
    return ctx.counters[COUNTERS[0]] / len(ctx.records)
