"""tts_p50_ms.<cell>: the median (nearest rank) of the same per-solve times
as tts_p95_ms, a steadier statistic beside the tail."""

import math


def read(ctx):
    times = sorted((r.t1 - r.t0) if r.verified else math.inf for r in ctx.records)
    p50 = times[math.ceil(0.5 * len(times)) - 1]
    return 1e3 * (p50 if math.isfinite(p50) else ctx.window_s)
