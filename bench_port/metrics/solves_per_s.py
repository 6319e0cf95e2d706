"""solves_per_s: formulas cleared per second. Solves in the window whose
witness the oracle verified against the formula, over the window's whole
wall (host clock, the last solve included)."""


def read(ctx):
    return sum(r.verified for r in ctx.records) / ctx.window_s
