"""host_ms_per_solve.<cell>: the mean, over the traced window's solves, of
the benchmark's span around each call (the entry point and the oracle)
less the time the card was busy inside it, in ms: the host's own work a
solve (compiling the formula, drawing the state, building the runner and
capturing the device loop, reading out, the oracle), as far as the card
waits for it."""


def read(ctx):
    if ctx.trace is None:
        return None
    spans = ctx.trace.spans("bench.solve")
    if not spans:
        return None
    host = [(b - a) * 1e-6 - ctx.trace.busy_s(a, b) for a, b in spans]
    return 1e3 * sum(host) / len(host)
