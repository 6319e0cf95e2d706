"""On the card, at each cell's own size (its batch, chunk and budget) with a
short window: the program as it is comes out correct, and the control, the
program's bfloat16 rounding, does not. Marked ``cuda``; skips without a
card. Run on the card:

    python3 -m pytest -q bench_port/tests/test_bench_port_card.py
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct_and_the_control_is_not_at_the_cells_size(cell, card):
    ok, _, _ = harness.run_cell(cell, 2**31 + 77, 3.0, False, device=card)
    assert ok["correct"] is True and ok["failed"] == 0
    control, checks, _ = harness.run_cell(cell, 2**31 + 78, 3.0, False, device=card,
                                          overrides={"matmul_dtype": "bfloat16"})
    assert control["correct"] is False
    assert checks["rows_off"][0] > checks["rows_off"][1]
