"""compile_ms.<cell>: the card-idle self time of the program's
``ode.compile`` spans (the formula compiled, the strategy and zeta
resolved), ms a solve over the traced window (``bench_port/spans.py``)."""

from bench_port import spans


def read(ctx):
    return spans.stage_ms(ctx, "compile_ms", ("ode.compile",))
