"""The readers of the program's stage spans and counters, on a trace
written by hand: self time with a nested stage, the card's busy time taken
out, a missing span and a span count that disagrees with its counter read
as nothing."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import harness, spans  # noqa: E402
from bench_port.trace import Trace  # noqa: E402

LAUNCHES = "odesat_tpu_torch.ops.device_loop:launches"
CAPTURES = "odesat_tpu_torch.ops.device_loop:captures"
BYTES = "odesat_tpu_torch.models.ode:readout_bytes"
B1 = "void lanes::lanes_chunk_kernel<true, true, true, false, false>(lanes::State)"


def x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def u(name, ts, dur):
    return x("user_annotation", name, ts, dur)


def solve_events():
    """One solve, times in us: each stage's card-idle self time in the
    comment beside it."""
    return [
        u("bench.window", 0, 1000),
        u("bench.solve", 5, 990),
        u("ode.solve", 10, 890),
        u("ode.compile", 20, 100),  # 100
        u("ode.state", 130, 50), x("kernel", "init", 150, 20),  # 50 - 20 = 30
        u("ode.build", 190, 50),  # 50
        u("device_loop.capture", 250, 50),  # 50
        u("device_loop.dispatch", 310, 390), x("kernel", B1, 320, 370),  # 390 - 370 = 20
        u("loop.decide", 710, 90),  # 90 - the build inside it = 50
        u("ode.build", 720, 40),  # 40
        u("ode.readout", 810, 40), x("gpu_memcpy", "Memcpy DtoH", 815, 30),  # 40 - 30 = 10
        u("ode.release", 860, 20),  # 20
        x("cuda_runtime", "cudaGraphExecDestroy", 862, 8),
        x("gpu_user_annotation", "ode.solve", 10, 890),  # not host work
    ]


def ctx_of(events, counters=None, solves=1):
    rec = type("R", (), {"steps": 64, "rows": 16384, "t0": 0.0, "t1": 1.0, "verified": True})
    counters = {LAUNCHES: 1, CAPTURES: 1, BYTES: 0} if counters is None else counters
    return harness.Context(None, {}, [rec] * solves, 1.0, 1.0, counters, Trace(events))


@pytest.mark.parametrize("metric, ms", [
    ("compile_ms.tts", 0.100),
    ("state_ms.tts", 0.030),
    ("build_ms.tts", 0.090),  # both builds, the one inside the decision too
    ("graph_ms.tts", 0.070),  # the capture and the release
    ("loop_ms.tts", 0.070),  # the dispatch and the decision less its build
    ("readout_ms.tts", 0.010),
])
def test_a_stage_reads_its_card_idle_self_time(metric, ms):
    ctx = ctx_of(solve_events())
    assert harness.reader(metric).read(ctx) == pytest.approx(ms)
    # the stages cover the solve's card-idle time but its own 20 us at the
    # edges ([10, 20], [120, 130], ...): the note says how much
    assert any(n.startswith("stages: 1 ode.solve spans") for n in ctx.notes)


def test_two_solves_halve_each_stage():
    assert harness.reader("compile_ms.tts").read(ctx_of(solve_events(), solves=2)) == (
        pytest.approx(0.050))


def test_the_split_covers_the_solve_but_its_gaps():
    got = spans.split(Trace(solve_events()))
    staged = sum(s for n, (_, s) in got.items() if n != spans.SOLVE)
    assert got["ode.build"][0] == 2 and got["loop.decide"] == (1, pytest.approx(50e-6))
    # ode.solve: 890 us less the card's 420 busy; the stages 370 of it
    assert got[spans.SOLVE] == (1, pytest.approx(470e-6))
    assert staged == pytest.approx(370e-6)


@pytest.mark.parametrize("metric", ["compile_ms.tts", "state_ms.tts", "build_ms.tts",
                                    "graph_ms.tts", "loop_ms.tts", "readout_ms.tts"])
def test_a_trace_without_the_programs_spans_reads_nothing(metric):
    events = [u("bench.window", 0, 1000), u("bench.solve", 5, 990), x("kernel", B1, 320, 370)]
    ctx = ctx_of(events, {LAUNCHES: 0, CAPTURES: 0, BYTES: 0})
    assert harness.reader(metric).read(ctx) is None
    assert ctx.notes and "not read" in ctx.notes[-1]


@pytest.mark.parametrize("metric, counters", [
    ("loop_ms.tts", {LAUNCHES: 2, CAPTURES: 1}),  # a dispatch the trace missed
    ("graph_ms.tts", {LAUNCHES: 1, CAPTURES: 2}),  # a capture the trace missed
    ("graph_ms.tts", {LAUNCHES: 1}),  # a program that counts no captures
])
def test_a_span_count_that_disagrees_with_its_counter_reads_nothing(metric, counters):
    ctx = ctx_of(solve_events(), counters)
    assert harness.reader(metric).read(ctx) is None
    assert "spans in the trace" in ctx.notes[-1]


def test_the_counters_read_per_solve():
    ctx = ctx_of(solve_events(), {LAUNCHES: 3, CAPTURES: 3, BYTES: 3 * 4112384}, solves=3)
    assert harness.reader("graph_captures_per_solve.tts").read(ctx) == 1.0
    assert harness.reader("readout_bytes_per_solve.tts").read(ctx) == 4112384


def test_a_counter_the_program_lacks_is_not_asked_for():
    assert spans.present(CAPTURES, BYTES) == (CAPTURES, BYTES)
    assert spans.present("odesat_tpu_torch.ops.device_loop:no_such_counter",
                         "no_such_module:launches") == ()
