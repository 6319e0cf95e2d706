"""The port's stochastic engine (odesat_tpu_torch/models/stoch.py,
ops/stoch_chunk.py) against the JAX package's, on the CPU.

* the torch counter hash equals ``_make_uniform01`` bit for bit;
* the scan twin equals JAX ``make_stoch_step`` exactly, given JAX's own
  uniforms (re-drawn here from the same key splits);
* ``stoch_chunk_plain``, the plain version of kernels B3 and B4, equals
  both Pallas kernels in interpret mode exactly (v, xl, done), in f32 and
  bf16, on bucketed mixed widths, batches that leave B3's and B4's last
  tile of lanes ragged (B = 1, 7, 13, 33), two PRNG blocks (B = 520, and
  B = 1000 with Bb = 512), and chunks in which chains finish;
* the gates, the ``fused`` ladder, the host loop and the CLI.

Every comparison is exact: the weights are integers, so the f32 sums
agree in any order while a variable's total stays below 2**24, which
these sizes never reach. The CUDA kernels run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odesat_tpu.cnf import CNFFormula as JCNF  # noqa: E402
from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.cnf import parse_dimacs_file as jparse  # noqa: E402
from odesat_tpu.models import stoch as jstoch  # noqa: E402
from odesat_tpu.ops import stoch_pallas  # noqa: E402
from odesat_tpu.utils.generate import random_ksat as jrandom_ksat  # noqa: E402
from odesat_tpu_torch import cli  # noqa: E402
from odesat_tpu_torch.cnf import (  # noqa: E402
    compile_formula,
    evaluate_cnf,
    map_values_by_indices,
    normalize_cnf_variables,
    parse_dimacs_file,
)
from odesat_tpu_torch.interop import (  # noqa: E402
    formula_arrays_from_numpy,
    stoch_state_from_numpy,
    stoch_state_to_numpy,
)
from odesat_tpu_torch.models import stoch as tstoch  # noqa: E402
from odesat_tpu_torch.ops import stoch_chunk as sc  # noqa: E402
from odesat_tpu_torch.preprocess import preprocess_formula  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig  # noqa: E402
from odesat_tpu_torch.utils.generate import random_ksat  # noqa: E402
from tests.torch_parity import port_formula  # noqa: E402

TRUE = "Checking if solution vector satisfies formula: true"
FALSE = "Checking if solution vector satisfies formula: false"


def _fa(formula, **kw):
    """The JAX package's compile of a JAX-package formula."""
    return jcompile(jnormalize(formula)[1], **kw)


def _mixed():
    """Widths 1, 2, 3 and 5 (unit clauses too: the stoch kernels take them)."""
    return JCNF([c for k, m in ((1, 4), (2, 40), (3, 60), (5, 30))
                 for c in jrandom_ksat(40, m, k=k, seed=20 + k).clauses], 40)


def _numpy_chains(fa, B, seed, xl_hi=3000):
    """v random 0/1, xl random in [1, xl_hi] (past 256, so bf16 rounds),
    done all false, from NumPy."""
    rng = np.random.default_rng(seed)
    v = rng.random((B, fa.n_vars_padded)) < 0.5
    xl = rng.integers(1, xl_hi + 1, (B, fa.n_clauses_padded)).astype(np.int32)
    return v, xl, np.zeros(B, bool)


def _raw_seed(key):
    """The launch seed the Pallas kernels' ``raw`` derives from a state key
    (stoch_pallas.py:230-233, :522-525)."""
    _, sub = jax.random.split(key)
    return int(jax.random.randint(sub, (1,), 0, 2**31 - 1, dtype=jnp.int32)[0])


def _pallas(kernel, fa, arrays, steps, bf16, key):
    make = {"fused": stoch_pallas.make_fused_stoch_chunk,
            "stream": stoch_pallas.make_stream_stoch_chunk}[kernel]
    v, xl, done = arrays
    state = jstoch.StochState(jnp.asarray(v), jnp.asarray(xl), jnp.asarray(done), key)
    out = make(fa, steps, interpret=True, matmul_dtype="bfloat16" if bf16 else "float32")(state)
    return np.asarray(out.v), np.asarray(out.xl), np.asarray(out.done)


def _plain(fa, arrays, steps, bf16, seed):
    spec = sc.stoch_spec(formula_arrays_from_numpy(fa), "cpu")
    state = stoch_state_from_numpy(*arrays, device="cpu")
    out = sc.stoch_chunk_plain(state, spec, steps, seed, sc.traj_block(state.v.shape[0]), bf16)
    return tuple(stoch_state_to_numpy(out))


def _assert_equal(a, b):
    for name, x, y in zip(("v", "xl", "done"), a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)


# ---------------------------------------------------------------- hash


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 2])
@pytest.mark.parametrize("blk", [0, 1, 7001])
@pytest.mark.parametrize("step", [0, 1, 99991, 2**31 - 1])
def test_hash_matches_make_uniform01(seed, blk, step):
    Bb, Np = 512, 1024
    block_seed = np.uint32((seed + blk * 0x632BE59B) % 2**32)
    want = np.asarray(stoch_pallas._make_uniform01(jnp.uint32(block_seed))(
        jnp.int32(step), (Bb, Np)))
    chains = torch.arange(blk * Bb, (blk + 1) * Bb, dtype=torch.int64)
    got = sc.uniform01(seed, chains, Bb, step, Np).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_traj_block_follows_pallas():
    assert [sc.traj_block(B) for B in (1, 5, 8, 13, 64, 200, 512, 520, 16384)] == [
        8, 8, 8, 8, 64, 128, 512, 512, 512]


# ---------------------------------------------------------------- scan twin


@pytest.mark.parametrize("case", ["ksat", "mixed bucketed", "small.cnf"])
def test_scan_twin_matches_jax_step(data_dir, case):
    if case == "ksat":
        fa = _fa(jrandom_ksat(30, 120, seed=1))
    elif case == "mixed bucketed":
        fa = _fa(_mixed(), bucket=True, min_bucket=32)
        assert len(fa.bucket_slices) > 1
    else:
        fa = _fa(jparse(os.path.join(data_dir, "small.cnf")))
    B = 13
    v, xl, done = _numpy_chains(fa, B, 4, xl_hi=60)
    key = jax.random.PRNGKey(9)
    jstate = jstoch.StochState(jnp.asarray(v), jnp.asarray(xl), jnp.asarray(done), key)
    jstep = jax.jit(jstoch.make_stoch_step(fa))
    tstate = stoch_state_from_numpy(v, xl, done, "cpu")
    tstep = tstoch.make_stoch_step(formula_arrays_from_numpy(fa), "cpu")
    for _ in range(10):
        _, sub = jax.random.split(jstate.key)  # the step's own split
        u = np.array(jax.random.uniform(sub, (B, fa.n_vars_padded), dtype=jnp.float32))
        jstate = jstep(jstate)
        tstate = tstep(tstate, torch.from_numpy(u))
        _assert_equal(stoch_state_to_numpy(tstate), tuple(np.asarray(a) for a in jstate[:3]))


# ---------------------------------------------------------------- plain vs Pallas


def _case(data_dir, name):
    if name.startswith("ksat B="):  # B = 1, 7, 33: a ragged last tile; 1000: two PRNG blocks
        return _fa(jrandom_ksat(30, 128, seed=0)), int(name.split("=")[1])
    if name == "mixed bucketed B=16":
        fa = _fa(_mixed(), bucket=True, min_bucket=32)
        assert len(fa.bucket_slices) > 1
        return fa, 16
    return _fa(jparse(os.path.join(data_dir, "small.cnf"))), 520  # two PRNG blocks


@pytest.mark.parametrize("kernel", ["fused", "stream"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["ksat B=13", "mixed bucketed B=16", "small.cnf B=520",
                                  "ksat B=1", "ksat B=7", "ksat B=33", "ksat B=1000"])
def test_plain_matches_pallas(data_dir, kernel, bf16, name):
    fa, B = _case(data_dir, name)
    arrays = _numpy_chains(fa, B, seed=B)
    if B > 1:
        arrays[2][1] = True  # a row done before the chunk comes out unchanged
    key = jax.random.PRNGKey(B)
    want = _pallas(kernel, fa, arrays, 16, bf16, key)
    got = _plain(fa, arrays, 16, bf16, _raw_seed(key))
    _assert_equal(got, want)
    if B > 1:
        assert (got[0][1] == arrays[0][1]).all() and (got[1][1] == arrays[1][1]).all()
    assert (got[0] != arrays[0]).any(), "no flips: the case tests nothing"


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_matches_pallas_as_chains_finish(bf16):
    """From a partly solved batch, chunks in which chains finish: the done
    latch from the pre-flip allsat, the weight update on the finishing
    step, and frozen done rows agree with both Pallas kernels."""
    fa = _fa(jrandom_ksat(16, 50, seed=3, planted=True))
    B, chunk = 24, 4
    state = _numpy_chains(fa, B, seed=5, xl_hi=1)
    seen = False
    for i in range(40):
        key = jax.random.PRNGKey(100 + i)
        got = _plain(fa, state, chunk, bf16, _raw_seed(key))
        before, after = int(state[2].sum()), int(got[2].sum())
        if 0 < before < after < B:
            for kernel in ("fused", "stream"):
                _assert_equal(got, _pallas(kernel, fa, state, chunk, bf16, key))
            was = state[2]
            assert (got[0][was] == state[0][was]).all() and (got[1][was] == state[1][was]).all()
            seen = True
            break
        state = got
    assert seen, "no chunk had chains done before it, chains finishing in it and chains running"


# ---------------------------------------------------------------- gates and ladder


def test_gates_on_hard_cnf(data_dir):
    fa = compile_formula(normalize_cnf_variables(
        parse_dimacs_file(os.path.join(data_dir, "hard.cnf")))[1])
    assert (fa.max_width, fa.n_clauses_padded, fa.n_vars_padded) == (3, 256, 128)
    assert sc.stoch_fused_smem_bytes(fa) == 4 * (3 * 256 + 129 + 480 + 256) + 128
    assert sc.stoch_fused_supported(fa) and sc.stoch_stream_supported(fa)
    assert tstoch.resolve_kernel(fa, "cuda") == "fused"
    assert tstoch.resolve_kernel(fa, "cpu") == "scan"
    assert tstoch.resolve_kernel(fa, "cpu", fused="on") == "fused"
    assert tstoch.resolve_kernel(fa, "cuda", fused="off") == "scan"


def test_gates_on_the_preprocessed_n1k_instance():
    """The benchmark's large instance (run_benchmarks.py config 4): past
    B3's gate, inside B4's."""
    reduced, _ = preprocess_formula(random_ksat(1000, 4300, k=3, seed=7, planted=True), 7.0)
    fa = compile_formula(normalize_cnf_variables(reduced)[1], bucket=True)
    assert (reduced.varnum, reduced.num_clauses) == (870, 6065)
    assert (fa.max_width, fa.n_clauses_padded, fa.n_vars_padded) == (9, 6528, 896)
    assert int((fa.lit_mask > 0).sum()) == 23191
    assert sc.stoch_fused_smem_bytes(fa) > sc.SMEM_LIMIT_BYTES
    assert sc.stoch_stream_smem_bytes(fa) == 4 * 6528 + 896
    assert tstoch.resolve_kernel(fa, "cuda") == "stream"
    assert tstoch.resolve_kernel(fa, "cpu", fused="on") == "stream"


def test_fused_on_raises_past_both_gates():
    formula = normalize_cnf_variables(random_ksat(2000, 58200, k=3, seed=1))[1]
    fa = compile_formula(formula)
    assert not sc.stoch_stream_supported(fa)
    assert tstoch.resolve_kernel(fa, "cuda") == "scan"
    with pytest.raises(ValueError, match="neither stoch kernel"):
        tstoch.resolve_kernel(fa, "cuda", fused="on")
    with pytest.raises(ValueError, match="gate"):
        sc.make_stoch_chunk(fa, 8, "stream", "float32", "cpu")


def test_kernel_wrappers_refuse_cpu_specs():
    fa = compile_formula(normalize_cnf_variables(random_ksat(20, 60, seed=2))[1])
    spec = sc.stoch_spec(fa, "cpu")
    state = tstoch.init_stoch_state(fa, 4, "cpu")
    for launch in (sc.stoch_fused_cuda, sc.stoch_stream_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            launch(state, spec, 8, 1, False)


# ---------------------------------------------------------------- runner, search, CLI


@pytest.mark.parametrize("fused", ["auto", "on"])
def test_search_solves_small_and_verifies(data_dir, fused):
    formula = parse_dimacs_file(os.path.join(data_dir, "small.cnf"))
    mapping, normalized = normalize_cnf_variables(formula)
    config = SolverConfig(ode=ODEConfig(steps=2000), batch_size=8, seed=0, chunk_steps=64)
    result = tstoch.search(normalized, config, device="cpu", fused=fused)
    assert result.solved_index is not None
    assert evaluate_cnf(map_values_by_indices(mapping, result.best_assignment()), formula)


@pytest.mark.parametrize("fused", ["auto", "on"])
def test_search_runs_exactly_its_budget_on_unsat(data_dir, fused):
    formula = normalize_cnf_variables(parse_dimacs_file(os.path.join(data_dir, "hard.cnf")))[1]
    config = SolverConfig(ode=ODEConfig(steps=300), batch_size=4, seed=1, chunk_steps=64)
    result = tstoch.search(formula, config, device="cpu", fused=fused)
    assert result.steps == 300 and result.solved_index is None


def test_search_is_reproducible_per_seed(data_dir):
    formula = normalize_cnf_variables(parse_dimacs_file(os.path.join(data_dir, "hard.cnf")))[1]
    config = SolverConfig(ode=ODEConfig(steps=96), batch_size=8, seed=7, chunk_steps=32)
    runs = [tstoch.search(formula, config, device="cpu", fused=f)
            for f in ("on", "on", "off", "off")]
    np.testing.assert_array_equal(runs[0].assignment, runs[1].assignment)
    np.testing.assert_array_equal(runs[2].assignment, runs[3].assignment)


def test_multi_runner_counts_exact_steps():
    fa = compile_formula(normalize_cnf_variables(random_ksat(20, 60, seed=4, planted=True))[1])
    gen = torch.Generator().manual_seed(0)
    chunk = tstoch.make_stoch_chunk_runner(fa, 8, "cpu", gen, fused="on")
    multi = tstoch.make_multi_stoch_runner(chunk, 8, 500)
    state, steps = multi(tstoch.init_stoch_state(fa, 16, "cpu"))
    assert bool(state.done.any()) and steps % 8 == 0 and 0 < steps < 4000


def test_interop_roundtrip():
    v = np.array([[True, False, True]])
    xl = np.array([[1, 21, 5]], dtype=np.int64)
    state = stoch_state_from_numpy(v, xl, np.array([False]), "cpu")
    assert (state.v.dtype, state.xl.dtype, state.done.dtype) == (torch.bool, torch.int32,
                                                                 torch.bool)
    back = stoch_state_to_numpy(state)
    np.testing.assert_array_equal(back.v, v)
    np.testing.assert_array_equal(back.xl, xl)


@pytest.mark.parametrize("extra", [[], ["--no-preprocess", "--matmul-dtype", "bfloat16"],
                                   ["--var-order", "bandwidth", "-r", "5"],
                                   ["--fused", "off"], ["--fused", "on", "--no-preprocess"]])
def test_cli_stoch_small_verifies(data_dir, capsys, extra):
    rc = cli.main(["stoch", "-f", os.path.join(data_dir, "small.cnf"), "-n", "2000", "-b", "8",
                   "--seed", "3", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert rc == 0
    assert TRUE in out
    assert "chains solved:" in out
    assert ("Preprocessing CNF formula..." in out) == ("--no-preprocess" not in extra)


def test_cli_stoch_easy_preprocessed_verifies(data_dir, capsys):
    rc = cli.main(["stoch", "-f", os.path.join(data_dir, "easy.cnf"), "-n", "20000", "-b", "32",
                   "--seed", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Clauses: " in out and " | Vars: " in out
    assert TRUE in out


def test_cli_stoch_hard_runs_its_budget_to_false(data_dir, capsys):
    rc = cli.main(["stoch", "-f", os.path.join(data_dir, "hard.cnf"), "--no-preprocess", "-n",
                   "300", "-b", "4", "--seed", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert FALSE in out
    assert "Steps run: 300 | chains solved: 0/4" in out


def test_cli_stoch_needs_a_card_or_device_cpu(data_dir, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["stoch", "-f", os.path.join(data_dir, "small.cnf")])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_stoch_missing_file_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["stoch", "-f", "/nonexistent.cnf", "--device", "cpu"])
    assert e.value.code == 2
    assert "input file not found" in capsys.readouterr().err


def test_port_formula_roundtrip_for_stoch(data_dir):
    """The CLI's preprocessing of a JAX-package formula: the port takes the
    same clauses."""
    jf = jparse(os.path.join(data_dir, "easy.cnf"))
    assert port_formula(jf).clauses == parse_dimacs_file(
        os.path.join(data_dir, "easy.cnf")).clauses
