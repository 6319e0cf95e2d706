"""The port's host layer (cnf/, utils/generate, interop) against the JAX
package: same parse, normalization, oracle and array compile, and a
package that never imports jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from odesat_tpu import cnf as jcnf  # noqa: E402
from odesat_tpu.utils import generate as jgen  # noqa: E402
from odesat_tpu_torch import cnf as tcnf  # noqa: E402
from odesat_tpu_torch.interop import formula_arrays_from_numpy  # noqa: E402
from odesat_tpu_torch.utils import generate as tgen  # noqa: E402
from tests.conftest import random_formula  # noqa: E402
from tests.torch_parity import port_formula  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_arrays_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", ["small", "easy", "hard"])
@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("window_sort", [False, True])
def test_compile_matches_jax_on_fixtures(data_dir, name, bucket, window_sort):
    path = os.path.join(data_dir, f"{name}.cnf")
    _, jnorm = jcnf.normalize_cnf_variables(jcnf.parse_dimacs_file(path))
    _, tnorm = tcnf.normalize_cnf_variables(tcnf.parse_dimacs_file(path))
    kw = dict(bucket=bucket, window_sort=window_sort)
    assert_arrays_equal(tcnf.compile_formula(tnorm, **kw), jcnf.compile_formula(jnorm, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("window_sort", [False, True])
def test_compile_matches_jax_on_random_formulas(seed, window_sort):
    """Mixed widths 1..5 with small buckets, so width bucketing really
    splits the clause axis; f32 and f64 layouts."""
    rng = np.random.default_rng(seed)
    formula = random_formula(rng, 20, 60, max_width=5, min_width=1)
    _, jnorm = jcnf.normalize_cnf_variables(formula)
    tnorm = port_formula(jnorm)
    for dtype in (np.float32, np.float64):
        kw = dict(dtype=dtype, clause_pad=8, var_pad=8, bucket=True, min_bucket=8,
                  window_sort=window_sort)
        tfa = tcnf.compile_formula(tnorm, **kw)
        jfa = jcnf.compile_formula(jnorm, **kw)
        assert len(tfa.bucket_slices) > 1
        assert_arrays_equal(tfa, jfa)
        np.testing.assert_array_equal(tcnf.slot_clause_map(tfa), jcnf.arrays.slot_clause_map(jfa))


def test_formula_arrays_from_numpy_round_trip(data_dir):
    _, jnorm = jcnf.normalize_cnf_variables(
        jcnf.parse_dimacs_file(os.path.join(data_dir, "easy.cnf"))
    )
    jfa = jcnf.compile_formula(jnorm, bucket=True)
    carried = formula_arrays_from_numpy(jfa)
    assert_arrays_equal(carried, jfa)
    assert carried.lit_var is not jfa.lit_var  # copies, not views


@pytest.mark.parametrize("seed", [0, 5])
def test_generators_draw_the_same_instances(seed):
    assert tgen.uf_instance(250, seed=seed).clauses == jgen.uf_instance(250, seed=seed).clauses
    for planted in (False, True):
        t = tgen.random_ksat(40, 170, k=3, seed=seed, planted=planted)
        j = jgen.random_ksat(40, 170, k=3, seed=seed, planted=planted)
        assert t.clauses == j.clauses and t.varnum == j.varnum
    t = tgen.random_local_ksat(60, 200, locality=16, seed=seed)
    assert t.clauses == jgen.random_local_ksat(60, 200, locality=16, seed=seed).clauses


@pytest.mark.parametrize("name", ["small", "easy", "hard"])
def test_parse_normalize_reorder_evaluate_match(data_dir, name):
    path = os.path.join(data_dir, f"{name}.cnf")
    jf, tf = jcnf.parse_dimacs_file(path), tcnf.parse_dimacs_file(path)
    assert tf.clauses == jf.clauses and tf.varnum == jf.varnum
    assert tcnf.cnf_to_dimacs(tf) == jcnf.cnf_to_dimacs(jf)
    jmap, jnorm = jcnf.normalize_cnf_variables(jf)
    tmap, tnorm = tcnf.normalize_cnf_variables(tf)
    assert tmap == jmap and tnorm.clauses == jnorm.clauses
    jmap2, jre = jcnf.bandwidth_reorder(jmap, jnorm)
    tmap2, tre = tcnf.bandwidth_reorder(tmap, tnorm)
    assert tmap2 == jmap2 and tre.clauses == jre.clauses
    rng = np.random.default_rng(0)
    for _ in range(4):
        bits = rng.integers(0, 2, size=tnorm.varnum).astype(bool)
        tvals = tcnf.map_values_by_indices(tmap, bits)
        jvals = jcnf.map_values_by_indices(jmap, bits)
        assert tvals == jvals
        assert tcnf.evaluate_cnf(dict(tvals), tf) == jcnf.evaluate_cnf(dict(jvals), jf)
        assert tcnf.render_variable_map(tvals) == jcnf.render_variable_map(jvals)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import odesat_tpu_torch, odesat_tpu_torch.models.ode, odesat_tpu_torch.models.loop\n"
        "import odesat_tpu_torch.ops.fused_chunk, odesat_tpu_torch.cli, odesat_tpu_torch.interop\n"
        "import odesat_tpu_torch.utils.timing\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'odesat_tpu' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
