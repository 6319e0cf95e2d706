"""The reduction from a profiler trace to the per-layer metrics, on a
trace written by hand."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402
from bench_port.trace import Trace  # noqa: E402

B1 = "void lanes::lanes_chunk_kernel<true, true, true, false, false>(lanes::State)"
B2 = "void lanes::lanes_chunk_kernel<false, true, true, false, false>(lanes::State)"


def x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.fixture
def trace():
    return Trace([
        x("user_annotation", "bench.window", 0, 100),
        x("user_annotation", "bench.solve", 5, 90),
        x("kernel", B1, 10, 20), x("kernel", B1, 20, 20),  # overlapping: busy once
        x("kernel", B2, 90, 50),  # past the window's end: clipped
        x("gpu_user_annotation", "bench.solve", 5, 90),  # not device work
        x("cpu_op", "aten::copy_", 45, 30),
        x("kernel", "before", -50, 10),  # outside the window
    ])


def test_busy_idle_spans_and_kernels(trace):
    assert trace.window_s == pytest.approx(100e-6)
    assert trace.busy_s() == pytest.approx(40e-6)  # [10, 40] and [90, 100]
    assert trace.busy_s(15, 50) == pytest.approx(25e-6)
    assert trace.kernels(r"lanes_chunk_kernel<true\b") == (2, pytest.approx(40e-6))
    assert trace.spans("bench.solve") == [(5.0, 95.0)]
    ops = dict(trace.device_ops())
    assert ops[B1] == pytest.approx(40e-6) and ops[B2] == pytest.approx(10e-6)
    # [0, 10]: the solve span is the innermost at its middle; [40, 90]: the copy
    assert dict(trace.idle_gaps()) == {"aten::copy_": pytest.approx(50e-6),
                                       "bench.solve": pytest.approx(10e-6)}


def _ctx(trace, launches):
    shapes = dict(K=3, Mp=256, Np=128, nnz=480, B=16384, chunk_steps=256, fixed=True)
    rec = type("R", (), {"steps": 256, "rows": 16384, "t0": 0.0, "t1": 1.0, "verified": False})
    return harness.Context(None, shapes, [rec], 1.0, 1.0,
                           {"odesat_tpu_torch.ops.fused_chunk:launches": launches}, trace)


def test_b1_roofline_reads_the_bound_over_b1s_time(trace):
    read = harness.reader("b1_roofline.rows").read
    from bench_port import counts

    t, _ = counts.ode_chunk_bound(3, 256, 128, 480, 16384, 128, True)  # 256 steps, 2 chunks
    assert read(_ctx(trace, 2)) == pytest.approx(100 * 2 * t / 40e-6)


def test_b1_roofline_reads_nothing_when_the_trace_missed_launches(trace):
    assert harness.reader("b1_roofline.tts").read(_ctx(trace, 3)) is None
    assert harness.reader("device_idle.rows").read(_ctx(trace, 2)) == pytest.approx(60.0)
    assert harness.reader("host_ms_per_solve.tts").read(_ctx(trace, 2)) == pytest.approx(
        1e3 * (90e-6 - 35e-6))  # busy inside the span: [10, 40] and [90, 95]
