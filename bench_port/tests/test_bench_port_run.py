"""A run of each cell driven on the CPU at a size a test run holds: the
result's line, the check passing on the program as it is, and failing on
the control (the program's own bfloat16 rounding) and on each fault the
cells can have, planted under the timed path. The program runs B1's plain
version here (``dv_strategy="fused"`` on CPU tensors), which B1 equals on
the card bit for bit."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402

SEED = 2**31 + 12345
SMALL = {
    "aim100.inter_fixed": dict(batch=32, steps=512, check={"solves": 2, "rows": 8}),
    "uf250.tts": dict(batch=32, steps=2048, pool=4096, check={"solves": 3, "rows": 8}),
}
PLAIN = {"dv_strategy": "fused"}


def run(cell, trace=False, overrides=None, seconds=1.0):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            overrides={**PLAIN, **(overrides or {})}, traffic=SMALL[cell])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_line_holds_what_the_driver_reads(cell, trace):
    result, checks, _ = run(cell, trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    manifest = harness.load_manifest()
    want = harness.per_layer_of(manifest, cell) if trace else harness.end_to_end_of(manifest, cell)
    for m in want:
        if trace and m["source"] == "device_trace" and "roofline" in m["name"]:
            continue  # no card, no B1 kernel in the trace
        got = result["metrics"][m["name"]]
        assert set(got) == {"value", "unit"} and got["unit"] == m["unit"]
        assert isinstance(got["value"], float)
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        for key in ("device_ops", "idle_gaps"):
            rows = result["breakdown"][key]
            assert len(rows) <= 10 and all(isinstance(n, str) and s >= 0 for n, s in rows)
    assert all(set(v) == {"value", "limit"} for v in result["checks"].values())
    assert {k: (v["value"], v["limit"]) for k, v in result["checks"].items()} == checks
    json.dumps(result)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    """The program's bfloat16 rounding (the precision below the
    configuration's float32) against the float32 reference."""
    result, checks, _ = run(cell, overrides={"matmul_dtype": "bfloat16"})
    assert result["correct"] is False and checks["rows_off"][0] > checks["rows_off"][1]


def _unchanged(orig):
    return lambda state, spec, n: state


def _half(orig):
    def half(state, spec, n):
        h = state.v.shape[0] // 2
        top = orig(type(state)(*(t[:h] for t in state)), spec, n)
        return type(state)(*(torch.cat([a, b[h:]]) for a, b in zip(top, state)))
    return half


@pytest.mark.parametrize("fault", [_unchanged, _half], ids=["state_unchanged", "half_the_batch"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_chunk_is_not_correct(cell, fault, monkeypatch):
    from odesat_tpu_torch.ops import fused_chunk

    monkeypatch.setattr(fused_chunk, "fused_chunk_plain", fault(fused_chunk.fused_chunk_plain))
    result, _, _ = run(cell)
    assert result["correct"] is False


def _claims_row_0(res):
    res.done[0] = True
    res.solved_index = 0


def _flips_the_witness(res):
    if res.solved_index is not None:
        res.assignment[res.solved_index, 0] ^= True


@pytest.mark.parametrize("cell, alter", [
    ("aim100.inter_fixed", _claims_row_0),
    ("uf250.tts", _claims_row_0),
    ("uf250.tts", _flips_the_witness),  # aim100 is UNSAT: no witness to alter
], ids=["aim100-claims_a_row_done", "uf250-claims_a_row_done", "uf250-flips_a_witness_bit"])
def test_an_altered_answer_is_not_correct(cell, alter, monkeypatch):
    from odesat_tpu_torch.models import ode

    orig = ode.simulate_batch

    def altered(*args, **kwargs):
        res = orig(*args, **kwargs)
        alter(res)
        return res

    monkeypatch.setattr(ode, "simulate_batch", altered)
    result, _, _ = run(cell)
    assert result["correct"] is False


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "uf250.tts",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "{" not in out.stdout and "CUDA" in out.stderr


def test_a_checkout_of_the_benchmark_alone_runs_nothing(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    has no program: the run fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys; sys.path.insert(0, '.'); from bench_port import harness; "
            "r = harness.run_cell('aim100.inter_fixed', 1, 1, False, device='cpu'); print(r)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and "odesat_tpu_torch" in out.stderr and out.stdout == ""


def test_a_run_whose_process_holds_jax_prints_no_result(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    with pytest.raises(ImportError, match="jaxlib"):
        run("aim100.inter_fixed")
