"""The solve's stage spans (``utils/logging.span``) on the CPU: under
``torch.profiler`` a ``simulate_batch`` call is one ``ode.solve`` span with
each stage nested inside it, as many times as its slices and runner builds
imply; the readout's byte counter; and with no profiler the span path
enters no torch operation."""

import itertools

import pytest

torch = pytest.importorskip("torch")

from torch.overrides import TorchFunctionMode  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from odesat_tpu_torch.cnf.formula import CNFFormula, Literal  # noqa: E402
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.utils import logging as tlog  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402

STAGES = ("ode.compile", "ode.state", "ode.build", "loop.decide", "ode.readout", "ode.release")


def _unsat():
    """Every sign pattern of three variables: UNSAT, so a solve runs its
    whole budget and its slices are the budget's."""
    return CNFFormula([tuple(Literal(v, bool(s)) for v, s in enumerate(signs))
                       for signs in itertools.product((0, 1), repeat=3)], 3)


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == "ode.solve" or e.name in STAGES]


@pytest.mark.parametrize(
    "steps, log_every, decides, builds",
    [
        (64, 0, 1, 2),  # one slice of four chunks: B1's runner and the multi wrapper
        (64, 1, 4, 1),  # a cadence: four host-paced slices of one runner
        (56, 1, 4, 2),  # and a tail: three slices of 16 steps, a runner of 8 for the last
    ],
)
def test_a_solve_nests_its_stages_in_one_solve_span(steps, log_every, decides, builds):
    config = SolverConfig(ode=ODEConfig(step_size=0.05, steps=steps), batch_size=4, seed=0,
                          chunk_steps=16, log_every_chunks=log_every)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = tode.simulate_batch(_unsat(), config, device="cpu")
    assert result.steps == steps and result.solved_index is None
    spans = _spans(prof)
    solves = [(a, b) for n, a, b in spans if n == "ode.solve"]
    assert len(solves) == 1
    (lo, hi), = solves
    counts = {n: 0 for n in STAGES}
    for n, a, b in spans:
        if n != "ode.solve":
            assert lo <= a <= b <= hi, n
            counts[n] += 1
    assert counts == {"ode.compile": 1, "ode.state": 1, "ode.build": builds,
                      "loop.decide": decides, "ode.readout": 1, "ode.release": 1}
    # the stages run in this order, the release last
    first = {n: min(a for m, a, _ in spans if m == n) for n in STAGES}
    assert sorted(STAGES, key=first.get) == list(STAGES)


@pytest.mark.parametrize("batch", [1, 5])
def test_the_readout_counts_its_bytes(batch):
    config = SolverConfig(ode=ODEConfig(step_size=0.05, steps=32), batch_size=batch, seed=1,
                          chunk_steps=16)
    before = tode.readout_bytes
    result = tode.simulate_batch(_unsat(), config, device="cpu")
    assert result.assignment.shape == (batch, 3)
    assert tode.readout_bytes - before == batch * 3 + batch


def test_with_no_profiler_a_span_enters_no_torch_operation(monkeypatch):
    class Calls(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.seen.append(func)
            return func(*args, **(kwargs or {}))

    assert tlog.span("ode.solve") is tlog.span("ode.compile")  # one shared no-op context
    with Calls() as calls:
        with tlog.span("ode.solve"), tlog.span("ode.compile"):
            pass
    assert calls.seen == []

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler active")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    config = SolverConfig(ode=ODEConfig(step_size=0.05, steps=32), batch_size=2, seed=0,
                          chunk_steps=16, log_every_chunks=1)
    assert tode.simulate_batch(_unsat(), config, device="cpu").steps == 32
