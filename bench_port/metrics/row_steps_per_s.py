"""row_steps_per_s: how fast a budget burns. Every row (trajectory, or
chain) times every step of every solve in the window, over the window's
whole wall (host clock, the last solve included)."""


def read(ctx):
    return sum(r.rows * r.steps for r in ctx.records) / ctx.window_s
