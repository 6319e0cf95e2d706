"""tts_p95_ms: the 95th percentile (nearest rank) of time to solution over
every solve of the window, each timed on the host clock from the call of
the entry point to the oracle's verdict. A solve without a verified witness
misses the tail: it ranks last, and if the percentile falls on one, the
value is the window's whole length."""

import math


def read(ctx):
    times = sorted((r.t1 - r.t0) if r.verified else math.inf for r in ctx.records)
    p95 = times[math.ceil(0.95 * len(times)) - 1]
    return 1e3 * (p95 if math.isfinite(p95) else ctx.window_s)
