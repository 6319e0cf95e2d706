"""loop_ms.<cell>: the card-idle self time of the multi-chunk loop on the
host: the program's ``device_loop.dispatch`` spans (the pointer block's
copy, the graph's launch, the one read that waits for it) and
``loop.decide`` spans (the host's decision after each slice), ms a solve
over the traced window (``bench_port/spans.py``). The trace's dispatch
spans must equal the program's own count (``ops/device_loop.launches``),
or the trace missed some and nothing is read."""

from bench_port import spans

COUNTERS = ("odesat_tpu_torch.ops.device_loop:launches",)


def read(ctx):
    if ctx.trace is None or not spans.spans_match(ctx, "loop_ms", "device_loop.dispatch",
                                                  COUNTERS[0]):
        return None
    return spans.stage_ms(ctx, "loop_ms", ("device_loop.dispatch", "loop.decide"))
