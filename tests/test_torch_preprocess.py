"""The port's preprocessor (odesat_tpu_torch/preprocess) and native loader
(odesat_tpu_torch/native) against the JAX package's Python preprocessor:
the same reduced formula and the same trace, witnesses that reconstruct,
and a native library, built from the JAX package's C++ source by path,
whose trace is byte-identical to the port's Python one."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from odesat_tpu.cnf import parse_dimacs_file as jparse  # noqa: E402
from odesat_tpu.preprocess import preprocess_formula as jpreprocess  # noqa: E402
from odesat_tpu_torch import native  # noqa: E402
from odesat_tpu_torch.cnf import CNFFormula, Literal, evaluate_cnf, parse_dimacs  # noqa: E402
from odesat_tpu_torch.cnf import parse_dimacs_file  # noqa: E402
from odesat_tpu_torch.preprocess import preprocess_formula, reconstruct_witness  # noqa: E402
from tests.conftest import brute_force_sat, random_formula  # noqa: E402
from tests.torch_parity import port_formula  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ for the native library")


def canonical_trace(trace):
    """Either package's trace as plain tuples: (kind, variable, sorted
    clauses of sorted (variable, negated) pairs)."""
    out = []
    for step in trace.steps:
        if hasattr(step, "modified_pos_clauses"):
            kind, clauses = "VE", step.modified_pos_clauses
        else:
            kind, clauses = "BCE", (step.clause,)
        out.append((kind, step.variable,
                    sorted(sorted((lit.variable, lit.is_negated) for lit in c) for c in clauses)))
    return out


def planted_formula(seed, n_vars=9, n_clauses=16, max_width=3):
    """A random formula over 1..n_vars that a hidden assignment satisfies,
    so that every case has a witness to reconstruct."""
    rng = np.random.default_rng(seed)
    hidden = rng.integers(0, 2, n_vars + 1).astype(bool)
    clauses = []
    for _ in range(n_clauses):
        width = int(rng.integers(1, max_width + 1))
        vs = rng.choice(np.arange(1, n_vars + 1), size=width, replace=False)
        negs = rng.integers(0, 2, width).astype(bool)
        keep = int(rng.integers(width))
        negs[keep] = not hidden[vs[keep]]  # this literal is true under `hidden`
        clauses.append(tuple(Literal(int(v), bool(n)) for v, n in zip(vs, negs)))
    return CNFFormula(clauses, n_vars)


@pytest.mark.parametrize("seed", range(20))
def test_python_path_matches_jax_on_random_formulas(seed):
    formula = random_formula(np.random.default_rng(seed), n_vars=10, n_clauses=22, max_width=3)
    ratio = 4.0 if seed % 2 else 7.0
    j_reduced, j_trace = jpreprocess(formula, ratio, native=False)
    t_reduced, t_trace = preprocess_formula(port_formula(formula), ratio, native=False)
    assert t_reduced.varnum == j_reduced.varnum
    assert t_reduced.clauses == j_reduced.clauses
    assert canonical_trace(t_trace) == canonical_trace(j_trace)


def test_python_path_matches_jax_on_easy_cnf(data_dir):
    path = os.path.join(data_dir, "easy.cnf")
    j_reduced, j_trace = jpreprocess(jparse(path), 7.0, native=False)
    t_reduced, t_trace = preprocess_formula(parse_dimacs_file(path), 7.0, native=False)
    assert t_reduced.varnum == j_reduced.varnum < 50
    assert t_reduced.clauses == j_reduced.clauses
    assert len(t_trace) > 0
    assert canonical_trace(t_trace) == canonical_trace(j_trace)


@pytest.mark.parametrize("seed", range(20))
def test_witness_reconstruction_roundtrip(seed):
    """Solve the reduced formula by brute force, reconstruct through the
    trace, verify against the original (tests/test_preprocess.py:72-85)."""
    formula = port_formula(planted_formula(seed))
    reduced, trace = preprocess_formula(formula, target_ratio=4.0, native=False)
    assignment = brute_force_sat(reduced)
    assert assignment is not None, "preprocessing must preserve satisfiability"
    reconstruct_witness(assignment, trace)
    assert evaluate_cnf(assignment, formula), "reconstructed witness must satisfy the original"


@needs_gxx
@pytest.mark.parametrize("seed", range(12))
def test_native_matches_python_byte_for_byte(seed):
    formula = port_formula(
        random_formula(np.random.default_rng(100 + seed), n_vars=12, n_clauses=30, max_width=4)
    )
    py_reduced, py_trace = preprocess_formula(formula, 7.0, native=False)
    nat_reduced, blob = native.preprocess_native_raw(formula, 7.0)
    assert nat_reduced.varnum == py_reduced.varnum
    assert nat_reduced.clauses == py_reduced.clauses
    assert blob == native.encode_trace(py_trace)
    assert native.decode_trace(blob).steps == py_trace.steps


@needs_gxx
def test_native_matches_python_on_easy_cnf(data_dir):
    formula = parse_dimacs_file(os.path.join(data_dir, "easy.cnf"))
    py_reduced, py_trace = preprocess_formula(formula, 7.0, native=False)
    nat_reduced, nat_trace = preprocess_formula(formula, 7.0)  # native when built
    assert native.build_info()["available"]
    assert nat_reduced.clauses == py_reduced.clauses
    assert nat_reduced.varnum == py_reduced.varnum
    assert native.encode_trace(nat_trace) == native.encode_trace(py_trace)


@needs_gxx
@pytest.mark.parametrize("name", ["small", "easy", "hard"])
def test_native_parse_matches_python(data_dir, name):
    with open(os.path.join(data_dir, f"{name}.cnf"), encoding="utf-8") as fh:
        text = fh.read()
    nat, py = native.parse_dimacs_native(text), parse_dimacs(text)
    assert nat.varnum == py.varnum
    assert nat.clauses == py.clauses


@needs_gxx
def test_native_builds_the_jax_source_by_path():
    info = native.build_info()
    assert info["available"], info
    assert native.SOURCE == os.path.join(REPO, "odesat_tpu", "native", "odesat_native.cc")
    assert os.path.dirname(info["path"]) == native.BUILD_DIR
    assert os.path.basename(info["path"]).startswith("libodesat_native-")


def test_encode_decode_roundtrip():
    formula = port_formula(planted_formula(3, n_vars=8, n_clauses=20))
    _, trace = preprocess_formula(formula, 7.0, native=False)
    assert len(trace) > 0
    blob = native.encode_trace(trace)
    assert native.decode_trace(blob).steps == trace.steps
    assert native.encode_trace(native.decode_trace(blob)) == blob


def test_new_modules_do_not_import_jax():
    code = (
        "import sys\n"
        "import odesat_tpu_torch.preprocess, odesat_tpu_torch.native\n"
        "import odesat_tpu_torch.models.stoch, odesat_tpu_torch.ops.stoch_chunk\n"
        "import odesat_tpu_torch.cli, odesat_tpu_torch.interop\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'odesat_tpu' not in sys.modules, 'the JAX package imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
