"""state_ms.<cell>: the card-idle self time of the program's ``ode.state``
spans (the initial state drawn or a snapshot loaded, the formula's tensors
uploaded, a mesh's inputs sharded), ms a solve over the traced window
(``bench_port/spans.py``)."""

from bench_port import spans


def read(ctx):
    return spans.stage_ms(ctx, "state_ms", ("ode.state",))
