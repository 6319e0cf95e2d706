"""The clause mesh's per-step chunks as the card captures them
(``odesat_tpu_torch/ops/scan_chunk.py``), on the CPU: what a capture
depends on that the CPU can check.

* The counter-hash uniforms drawn from the seed word (``Uniforms.next``,
  the word a captured chunk reads on the card) equal ``uniform01`` and
  ``TiledUniforms.draw`` from the integer seed, bit for bit.
* The B7 calls a chunk declares (``ScanChunk.b7_calls``: what a capture
  begins, holds and checks) equal the calls a spy on
  ``ops/butterfly.butterfly`` counts in a CPU run of the same steps on a
  gloo world, by group: fixed, adaptive, a shared dt, stoch.
* The stoch clause twin's runner consumes its input (its steps flip the
  input's own chains) and equals the JAX package's stoch clause step on
  the same explicit state and the same uniforms.

Tolerances: none. The uniforms are integer hashes; the stoch weights are
integers in f32. The captured chunk itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from odesat_tpu.cnf import compile_formula as jcompile  # noqa: E402
from odesat_tpu.cnf import normalize_cnf_variables as jnormalize  # noqa: E402
from odesat_tpu.models import ode as jode  # noqa: E402
from odesat_tpu.models import stoch as jstoch  # noqa: E402
from odesat_tpu.utils.generate import random_ksat as jrandom_ksat  # noqa: E402
from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy  # noqa: E402
from odesat_tpu_torch.models.stoch import StochState  # noqa: E402
from odesat_tpu_torch.ops import stoch_chunk as sc  # noqa: E402
from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded  # noqa: E402
from odesat_tpu_torch.ops.tiles import TILE, untile  # noqa: E402
from odesat_tpu_torch.parallel import launch, sharded  # noqa: E402
from odesat_tpu_torch.utils.config import ODEConfig  # noqa: E402
from odesat_tpu_torch.utils.generate import random_ksat  # noqa: E402


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 2])
@pytest.mark.parametrize("B", [7, 64])
def test_seed_word_draws_equal_the_integer_seed_draws(seed, B):
    """A chunk's draws from the seed word (set once, advanced by each draw),
    in rows and in tiles, equal uniform01 and TiledUniforms.draw from the
    integer seed at every step, bit for bit; so does a step past 2**16."""
    Np, Bb = 40, sc.traj_block(B)
    chains = torch.arange(B, dtype=torch.int64)
    rows = sc.Uniforms(chains.unsqueeze(1), torch.arange(Np, dtype=torch.int64).unsqueeze(0), Bb)
    tiled = sc.TiledUniforms(-(-B // TILE), Bb, Np, "cpu")
    rows.set_seed(seed)
    tiled.set_seed(seed)
    for t in range(8):
        want = sc.uniform01(seed, chains, Bb, t, Np)
        assert torch.equal(rows.next().view(torch.int32), want.view(torch.int32))
        got = tiled.next().clone()
        assert torch.equal(untile(got, B).view(torch.int32), want.view(torch.int32))
        assert torch.equal(got.view(torch.int32), tiled.draw(seed, t).view(torch.int32))
    far = 70000
    rows.word.fill_((seed + sc._at_step(far)) & 0xFFFFFFFF)
    assert torch.equal(rows.next().view(torch.int32),
                       sc.uniform01(seed, chains, Bb, far, Np).view(torch.int32))


def _formula(S, plan):
    f = normalize_cnf_variables(random_ksat(40, 160, k=3, seed=8))[1]
    if plan:
        return compile_stream_sharded(f, S, min_bucket=32)[0]
    return compile_formula(f, clause_pad=64 * S)


def test_the_b7_calls_a_chunk_declares_are_those_its_steps_make():
    """On a 1x2 gloo world (B5 fixed and adaptive, the B8 path, the twin
    fixed and adaptive, the stoch twin) and a 2x2 one (the twin with a
    shared adaptive dt: its clause calls, then the dt's max over the
    trajectory group every step), the B7 calls a chunk declares, by group,
    equal those a spy counts in a CPU run of its steps."""
    from tests import mesh_capture_worker as w

    fixed, adaptive = ODEConfig(step_size=0.01), ODEConfig(tolerance=1e-3)
    plan, plain = _formula(2, True), _formula(2, False)
    steps = 3
    cases = [("B5", plan, fixed, 8, steps), ("B5", plan, adaptive, 8, steps),
             ("B8", plan, None, 8, steps),
             ("twin", plain, ODEConfig(step_size=0.01, dtype="float64"), 8, steps),
             ("twin", plain, ODEConfig(tolerance=1e-3, dtype="float64"), 8, steps),
             ("stoch_twin", plain, None, 8, steps)]
    values = launch.spawn(launch.run_all, 1, 2, "gloo", "cpu", timeout_s=300,
                          args=([(w.b7_calls_against_a_spy, (cases,))],))
    want = [steps, 3 * steps, steps, steps, 3 * steps, steps]
    for (declared, counted), n in zip(values[0], want):
        assert declared == counted == {"clause": n}
    shared = ODEConfig(tolerance=1e-3, dt_mode="shared")
    values = launch.spawn(launch.run_all, 2, 2, "gloo", "cpu", timeout_s=300,
                          args=([(w.b7_calls_against_a_spy,
                                  ([("twin", _formula(2, False), shared, 4, steps)],))],))
    ((declared, counted),) = values[0]
    assert declared == counted == {"clause": 3 * steps, "traj": steps}


def test_stoch_clause_twin_consumes_its_input_and_equals_jax(monkeypatch):
    """The stoch clause twin's runner (no shard plan, S=1) flips its input's
    own chains, and its chunk equals the JAX package's stoch clause step
    (``make_stoch_clause_step``, its psum over a clause axis of one) from the
    same explicit state, fed the same counter-hash uniforms, exactly."""
    jfa = jcompile(jnormalize(jrandom_ksat(30, 120, k=3, seed=4))[1])
    tfa = formula_arrays_from_numpy(jfa)
    B, steps, Np = 8, 5, jfa.n_vars_padded
    rng = np.random.default_rng(6)
    v = rng.random((B, Np)) < 0.5
    xl = rng.integers(1, 50, (B, jfa.n_clauses_padded)).astype(np.int32)
    done = rng.random(B) < 0.25
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator().manual_seed(11)))
    run = sharded.make_clause_stoch_runner(tfa, steps, "cpu", torch.Generator().manual_seed(11))
    state = StochState(torch.as_tensor(v.copy()), torch.as_tensor(xl.copy()),
                       torch.as_tensor(done.copy()))
    out = run(state)
    assert out.v.data_ptr() == state.v.data_ptr()  # consumed: flipped where it lies
    chains = torch.arange(B, dtype=torch.int64)
    draws = iter([jnp.asarray(sc.uniform01(seed, chains, sc.traj_block(B), t, Np).numpy())
                  for t in range(steps)])
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, dtype=None: next(draws))
    step = jstoch.make_stoch_clause_step("clause")
    dev = jode.formula_device(jfa)
    dev = jax.tree.map(lambda x: None if x is None else x[None], dev)
    st = jstoch.StochState(jnp.asarray(v)[None], jnp.asarray(xl)[None], jnp.asarray(done)[None],
                           jax.random.PRNGKey(0)[None])
    for _ in range(steps):
        st = jax.vmap(step, axis_name="clause")(st, dev)
    for got, want in zip(out, (st.v[0], st.xl[0], st.done[0])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["B5", "B8", "stoch_twin"])
def test_a_chunk_that_declares_b7_calls_refuses_the_device_loop(kind):
    """The clause mesh's chunks (B5's, the B8 path's, the stoch clause
    twin's; here at S=1 on the CPU) declare their B7 calls, and the device
    loop refuses a chunk that declares any, whatever count it adds to: only
    the host rebases their flags and sets a stoch chunk's seed word. A scan
    chunk that declares none is let in, even one counted as the mesh's."""
    import chip_smoke
    from odesat_tpu_torch.ops.scan_chunk import ScanChunk
    from tests import mesh_capture_worker as w

    fa = _formula(1, kind != "stoch_twin")
    ode = ODEConfig(step_size=0.01) if kind == "B5" else None
    make, state, dev = chip_smoke.mesh_case(None, "cpu", kind, fa, ode, 8, 2, 3)
    run = make()
    run(state)
    chunk = w.chunk_of(run)
    assert isinstance(chunk, ScanChunk) and chunk.calls is not None
    with pytest.raises(RuntimeError, match="declares B7 calls"):
        chunk.buffers(state, dev)
    ScanChunk(lambda s, d: s, 2, "cpu", counter="mesh_launches")._check_loop()
