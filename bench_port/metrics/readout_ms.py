"""readout_ms.<cell>: the card-idle self time of the program's
``ode.readout`` spans (the done flags and the assignment copied to the
host, the result built), ms a solve over the traced window
(``bench_port/spans.py``)."""

from bench_port import spans


def read(ctx):
    return spans.stage_ms(ctx, "readout_ms", ("ode.readout",))
