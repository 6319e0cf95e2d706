"""graph_launches_per_solve.<cell>: the device loop's graph launches
(``odesat_tpu_torch.ops.device_loop.launches``) over the window, a solve."""

COUNTERS = ("odesat_tpu_torch.ops.device_loop:launches",)


def read(ctx):
    return ctx.counters[COUNTERS[0]] / len(ctx.records)
