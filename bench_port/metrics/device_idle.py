"""device_idle.<cell>: the share (%) of the traced window in which the
card ran nothing: 100 x (1 - the union of its kernels, copies and fills /
the window), from the profiler's trace."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
