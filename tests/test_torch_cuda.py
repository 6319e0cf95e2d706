"""The CUDA chunk kernel against its plain torch version, on the card.

These tests need an NVIDIA Hopper GPU and nvcc (the kernel has no CPU
mode) and skip without a CUDA device. The file imports no jax, so it runs
on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: float32 rtol 2e-4 / atol 2e-5 (tests/test_fused.py's), done
exact; repeats bit-identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu_torch.cnf import CNFFormula, compile_formula, normalize_cnf_variables  # noqa: E402
from odesat_tpu_torch.models import ode as tode  # noqa: E402
from odesat_tpu_torch.interop import state_from_numpy  # noqa: E402
from odesat_tpu_torch.models.ode import simulate_batch  # noqa: E402
from odesat_tpu_torch.ops import fused_chunk as fc  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
from odesat_tpu_torch.utils.generate import random_ksat  # noqa: E402

# self-contained (no tests.* imports): another installed package named
# `tests` can shadow this directory on a machine that lacks jax
F32 = dict(rtol=2e-4, atol=2e-5)


def _state(fa, B, seed, device):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, size=(B, fa.n_vars_padded)).astype(np.float32)
    xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
    return state_from_numpy(v, xs, np.ones_like(xs), np.full(B, 0.01, np.float32),
                            np.zeros(B, bool), device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunk kernel has no CPU mode")
    return torch.device("cuda")


def _formula(seed=0, widths=(3,)):
    clauses = [c for k in widths for c in random_ksat(30, 80, k=k, seed=seed + k).clauses]
    return normalize_cnf_variables(CNFFormula(clauses, 30))[1]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("rigidity", ["paper", "reference"])
@pytest.mark.parametrize("widths", [(3,), (2, 4)])
def test_kernel_matches_plain(cuda, mode, rigidity, widths):
    fa = compile_formula(_formula(widths=widths))
    ode = ODEConfig(step_size=0.02 if mode == "fixed" else None, rigidity=rigidity)
    fn = fc.make_fused_chunk(fa, 0.05, ode, 32, cuda)
    state = _state(fa, 37, 0, cuda)
    before = fc.launches
    out = fn(state)
    again = fn(state)
    ref = fc.fused_chunk_plain(state, fn.spec, 32)
    torch.cuda.synchronize()
    assert fc.launches == before + 2
    for name in ("v", "xs", "xl", "dt"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name), **F32)
    assert torch.equal(out.done, ref.done)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_kernel_matches_plain_as_trajectories_finish(cuda, mode):
    """From a partly solved batch, chunks in which rows finish: the done
    latch, the fixed update-then-freeze and the adaptive no-advance branch
    agree with the plain version, and rows done before a chunk stay put."""
    formula = normalize_cnf_variables(random_ksat(50, 200, seed=3, planted=True))[1]
    fa = compile_formula(formula)
    fn = fc.make_fused_chunk(fa, 0.05, ODEConfig(step_size=0.05 if mode == "fixed" else None),
                             8, cuda)
    state, seen = _state(fa, 64, 2, cuda), False
    for _ in range(2000):
        out = fn(state)
        ref = fc.fused_chunk_plain(state, fn.spec, 8)
        for name in ("v", "xs", "xl", "dt"):
            torch.testing.assert_close(getattr(out, name), getattr(ref, name), **F32)
            assert torch.equal(getattr(out, name)[state.done], getattr(state, name)[state.done])
        assert torch.equal(out.done, ref.done)
        before, after = int(state.done.sum()), int(out.done.sum())
        state = out
        if 0 < before < after < 64:
            seen = True
            break
    assert seen, "no chunk had rows done before it, rows finishing in it and rows running"


@pytest.mark.cuda
def test_smem_gate_matches_the_kernel(cuda):
    lib, _ = fc.load_library()
    fa = compile_formula(_formula())
    nnz = int((fa.lit_mask > 0).sum())
    K, Mp = fa.lit_var.shape
    for fixed in (True, False):
        want = lib.fused_chunk_smem_bytes(fa.n_vars_padded, Mp, K, nnz, int(fixed))
        assert fc.fused_smem_bytes(fa, fixed) == want


@pytest.mark.cuda
def test_simulate_batch_goes_through_the_kernel(cuda):
    formula = normalize_cnf_variables(random_ksat(50, 200, seed=3, planted=True))[1]
    before = fc.launches
    config = SolverConfig(ode=ODEConfig(step_size=0.05, steps=4000), batch_size=64, seed=0)
    result = simulate_batch(formula, config, device=cuda)
    assert fc.launches > before
    assert result.any_solved


@pytest.mark.cuda
@pytest.mark.parametrize("dv_strategy", ["gather", "segment_sum"])
def test_twin_on_cuda_matches_the_cpu(cuda, dv_strategy):
    """Unit clauses keep a formula off the kernel; the torch twin then runs
    on the card. Same state, 20 fixed steps, CUDA vs CPU (the sums run in
    other orders, hence the f32 tolerance)."""
    formula = _formula(widths=(1, 3))
    fa = compile_formula(formula)
    ode = ODEConfig(step_size=0.02, dv_strategy=dv_strategy)
    assert tode.resolve_strategy(fa, ODEConfig(step_size=0.02), cuda) != "fused"
    step = tode.make_step_fn(fa, 0.01, ode)
    outs = []
    for device in ("cpu", cuda):
        state, dev = _state(fa, 16, 1, device), tode.formula_device(fa, device)
        for _ in range(20):
            state = step(state, dev)
        outs.append(state)
    for name in ("v", "xs", "xl"):
        torch.testing.assert_close(getattr(outs[1], name).cpu(), getattr(outs[0], name),
                                   rtol=1e-4, atol=1e-5)
    assert torch.equal(outs[1].done.cpu(), outs[0].done)
