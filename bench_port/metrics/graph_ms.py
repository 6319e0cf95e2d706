"""graph_ms.<cell>: the card-idle self time of the device loop's graph
made and destroyed: the program's ``device_loop.capture`` spans (graph
creation, body capture, instantiation) and ``ode.release`` spans (the
solve's runners dropped, and with them the graph), ms a solve over the
traced window (``bench_port/spans.py``). The trace's capture spans must
equal the program's own count (``ops/device_loop.captures``), or the trace
missed some and nothing is read."""

from bench_port import spans

COUNTERS = spans.present("odesat_tpu_torch.ops.device_loop:captures")


def read(ctx):
    if ctx.trace is None or not spans.spans_match(
            ctx, "graph_ms", "device_loop.capture", "odesat_tpu_torch.ops.device_loop:captures"):
        return None
    return spans.stage_ms(ctx, "graph_ms", ("device_loop.capture", "ode.release"))
