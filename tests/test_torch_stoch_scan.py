"""The stoch twin's chunk (``odesat_tpu_torch/ops/scan_chunk.StochScanChunk``,
built by ``models/stoch.make_stoch_chunk_runner`` past the kernels' gates or
with ``fused="off"``) on the CPU.

On a CUDA state the chunk is CUDA graphs of the steps and their uniform
draws, captured once a batch shape, with the device generator registered
(tests/test_torch_cuda.py holds it to the host-paced loop on the card); on
a CPU state it is the plain loop of steps. Here:

* the runner equals the loop of ``make_stoch_step`` over uniforms drawn
  from a copy of its device generator, bit for bit, at chunk lengths 1, 64
  and 100 (a graph's part and a remainder on the card), over two chunks,
  and leaves the generator in the loop's state;
* fed the uniforms of JAX's jitted scan chunk (``odesat_tpu/models/
  stoch.py:227-235``, re-drawn here from the same key splits), the chunk
  equals it exactly, as tests/test_torch_stoch.py holds the step;
* a dispatch over the twin keeps the host loop (JAX's scan path has no
  multi-chunk runner): the device loop refuses the chunk, B3's runner takes
  it;
* a snapshot of the state and the generators taken between chunks, restored
  into a runner built anew, continues to the uninterrupted run's flips.

Every comparison is exact: the weights are integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.models import stoch as jstoch  # noqa: E402
from odesat_tpu.utils.generate import random_ksat as jrandom_ksat  # noqa: E402
from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables  # noqa: E402
from odesat_tpu_torch.interop import (  # noqa: E402
    formula_arrays_from_numpy,
    stoch_state_from_numpy,
    stoch_state_to_numpy,
)
from odesat_tpu_torch.models import stoch as tstoch  # noqa: E402
from odesat_tpu_torch.models.loop import run_chunks  # noqa: E402
from odesat_tpu_torch.ops import _cuda, scan_chunk  # noqa: E402
from odesat_tpu_torch.ops.device_loop import KernelChunk  # noqa: E402
from odesat_tpu_torch.utils.generate import random_ksat  # noqa: E402

B = 8
LENGTHS = [1, 64, 100]


def _jax_fa():
    return jcompile(jnormalize(jrandom_ksat(30, 126, seed=1))[1])


def _chains(fa, seed=4):
    """v random 0/1, xl random in [1, 60], done all false, from NumPy."""
    rng = np.random.default_rng(seed)
    v = rng.random((B, fa.n_vars_padded)) < 0.5
    xl = rng.integers(1, 61, (B, fa.n_clauses_padded)).astype(np.int32)
    return v, xl, np.zeros(B, bool)


def _case():
    jfa = _jax_fa()
    fa = formula_arrays_from_numpy(jfa)
    return jfa, fa, stoch_state_from_numpy(*_chains(jfa), "cpu")


def _twin(fa, n, seed=3):
    return tstoch.make_stoch_chunk_runner(fa, n, "cpu", torch.Generator().manual_seed(seed),
                                          fused="off")


def _copy(gen):
    return torch.Generator().set_state(gen.get_state())


def _equal(a, b):
    for name, x, y in zip(tstoch.StochState._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("n", LENGTHS)
def test_runner_on_the_cpu_is_the_loop_of_steps(monkeypatch, n):
    """Two chunks of n steps equal 2n steps of make_stoch_step over
    torch.rand draws from a copy of the runner's generator, bit for bit;
    both generators end in one state; nothing is built, captured or
    counted."""

    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load a CUDA library")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    _, fa, state = _case()
    chunk = _twin(fa, n)
    assert isinstance(chunk, scan_chunk.StochScanChunk) and isinstance(chunk, KernelChunk)
    assert chunk.chunk_steps == n and chunk.generator is None
    gen = _copy(chunk.device_generator)
    step = tstoch.make_stoch_step(fa, "cpu")
    before = (scan_chunk.launches, scan_chunk.stoch_launches)
    got = want = state
    for _ in range(2):
        got = chunk(got)
        for _ in range(n):
            want = step(want, torch.rand((B, fa.n_vars_padded), generator=gen))
        _equal(got, want)
    assert torch.equal(chunk.device_generator.get_state(), gen.get_state())
    assert (scan_chunk.launches, scan_chunk.stoch_launches) == before
    assert chunk.graphs == {}
    assert (got.v != state.v).any(), "no flips: the case tests nothing"


@pytest.mark.parametrize("n", LENGTHS)
def test_chunk_fed_jax_uniforms_equals_the_jax_scan_chunk(n):
    """JAX's scan chunk (fused="off", jitted lax.scan) from a state and key;
    the port's chunk over the same state, its step fed the uniforms JAX's
    steps draw (each step splits the key and draws from the sub-key): v, xl
    and done equal."""
    jfa, fa, state = _case()
    v, xl, done = _chains(jfa)
    key = jax.random.PRNGKey(7)
    jout = jstoch.make_stoch_chunk_runner(jfa, n, fused="off", donate=False)(
        jstoch.StochState(jnp.asarray(v), jnp.asarray(xl), jnp.asarray(done), key))
    uniforms = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        uniforms.append(torch.from_numpy(np.array(
            jax.random.uniform(sub, (B, jfa.n_vars_padded), dtype=jnp.float32))))
    step = tstoch.make_stoch_step(fa, "cpu")
    draws = iter(uniforms)
    chunk = scan_chunk.StochScanChunk(lambda st, u: step(st, next(draws)), n, "cpu",
                                      torch.Generator().manual_seed(0), fa.n_vars_padded)
    got = stoch_state_to_numpy(chunk(state))
    for name, a, b in zip(("v", "xl", "done"), got, jout[:3]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert next(draws, None) is None
    np.testing.assert_array_equal(jout.key, key)


def test_a_dispatch_over_the_twin_keeps_the_host_loop():
    """The twin's chunk is no device-loop chunk (only the host advances its
    generator, once a replay; JAX's scan path has no multi-chunk runner):
    its body refuses the loop, while B3's runner takes it. The multi-chunk
    runner over the twin is run_chunks over the chunk, flip for flip, and
    stops in the dispatch once a chain is done."""
    fa = compile_formula(normalize_cnf_variables(random_ksat(20, 60, seed=4, planted=True))[1])
    state = tstoch.init_stoch_state(fa, 16, "cpu")
    twin = _twin(fa, 8)
    b3 = tstoch.make_stoch_chunk_runner(fa, 8, "cpu", torch.Generator().manual_seed(0),
                                        fused="on")
    assert not tstoch.takes_device_loop(twin) and tstoch.takes_device_loop(b3)
    for hook, args in ((twin.buffers, (state, ())), (twin.body, (state, None, 0, False, 0, 0))):
        with pytest.raises(RuntimeError, match="device generator"):
            hook(*args)
    assert twin.graphs == {}
    other = _twin(fa, 8)
    got, steps = tstoch.make_multi_stoch_runner(twin, 8, 40)(state)
    want, want_steps = run_chunks(other, 8, 40)(state)
    assert steps == want_steps and 0 < steps < 8 * 40 and bool(got.done.any())
    _equal(got, want)
    assert torch.equal(twin.device_generator.get_state(), other.device_generator.get_state())


@pytest.mark.parametrize("n", [16, 100])
def test_a_snapshot_between_chunks_resumes_to_the_same_flips(tmp_path, n):
    """Four chunks uninterrupted; and two chunks, a snapshot (the state
    through utils/checkpoint, the generators through generator_states), a
    runner built anew from another seed, the generators restored, two more
    chunks: the same chains, bit for bit, and the same generator states."""
    from odesat_tpu_torch.utils import checkpoint as ck

    _, fa, state = _case()
    whole_gen = torch.Generator().manual_seed(11)
    whole = tstoch.make_stoch_chunk_runner(fa, n, "cpu", whole_gen, fused="off")
    want = state
    for _ in range(4):
        want = whole(want)
    part_gen = torch.Generator().manual_seed(11)
    part = tstoch.make_stoch_chunk_runner(fa, n, "cpu", part_gen, fused="off")
    mid = part(part(state))
    path = str(tmp_path / "snap.npz")
    ck.save_state(path, mid, 2 * n, extra=tstoch.generator_states(part_gen, part))
    loaded, steps, _ = ck.load_state(path, tstoch.StochState)
    assert steps == 2 * n
    resumed_gen = torch.Generator().manual_seed(99)
    resumed = tstoch.make_stoch_chunk_runner(fa, n, "cpu", resumed_gen, fused="off")
    tstoch.restore_generators(ck.load_generator_states(path), resumed_gen, resumed)
    got = stoch_state_from_numpy(*loaded, device="cpu")
    for _ in range(2):
        got = resumed(got)
    _equal(got, want)
    assert torch.equal(resumed.device_generator.get_state(), whole.device_generator.get_state())
    assert torch.equal(resumed_gen.get_state(), whole_gen.get_state())


@pytest.mark.parametrize("fused", ["auto", "on", "off"])
def test_cli_fused_flag_reaches_the_search(data_dir, capsys, monkeypatch, fused):
    """``stoch --fused`` is the search's ``fused``: 'off' runs the twin's
    chunk, 'on' the kernels' (their plain version on the CPU); hard.cnf
    ends false after exactly its budget either way."""
    import os

    from odesat_tpu_torch import cli

    seen, runners = [], []
    search, make = tstoch.search, tstoch.make_stoch_chunk_runner
    monkeypatch.setattr(tstoch, "search",
                        lambda *a, **k: seen.append(k["fused"]) or search(*a, **k))
    monkeypatch.setattr(tstoch, "make_stoch_chunk_runner",
                        lambda *a, **k: runners.append(make(*a, **k)) or runners[-1])
    rc = cli.main(["stoch", "-f", os.path.join(data_dir, "hard.cnf"), "--no-preprocess", "-n",
                   "64", "-b", "4", "--chunk-steps", "16", "--seed", "0", "--device", "cpu",
                   "--fused", fused])
    out = capsys.readouterr().out
    assert rc == 0 and "Steps run: 64 | chains solved: 0/4" in out
    assert seen == [fused] and runners
    twin = fused != "on"  # auto on the CPU is the twin, as the JAX package off the TPU
    assert all(isinstance(r, scan_chunk.StochScanChunk) == twin for r in runners)
