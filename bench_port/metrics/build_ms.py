"""build_ms.<cell>: the card-idle self time of the program's ``ode.build``
spans (a chunk runner built: B1's spec, tables and their uploads; the
multi-chunk wrapper), ms a solve over the traced window
(``bench_port/spans.py``)."""

from bench_port import spans


def read(ctx):
    return spans.stage_ms(ctx, "build_ms", ("ode.build",))
