"""The benchmark's yardstick on the CPU: the count functions against hand
counts, the formulas and the seeded instance stream, the layout and the
plain reference against the program's own compile and B1's plain version
(the program is imported here only to be compared with), and the import
guard."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from bench_port import counts, formulas, reference  # noqa: E402

AIM = os.path.join(BENCH, "configs", "aim-100-1_6-no-1.cnf")


def aim():
    with open(AIM, encoding="utf-8") as fh:
        return formulas.normalized(formulas.read_dimacs(fh.read()))


def uf(seed=5):
    f = formulas.planted_ksat(np.random.default_rng(seed), 1, 250, 1065)
    return formulas.Formula(f.var[0], f.neg[0], f.varnum)


def test_counts_by_hand_for_hard_cnf():
    lay = formulas.layout(aim())
    assert (lay.K, lay.Mp, lay.Np, lay.nnz) == (3, 256, 128, 480)
    assert counts.ode_step_ops(480, 128, 256, True) == 15 * 480 + 3 * 128 + 10 * 256 == 10144
    assert counts.table_bytes(3, 256, 128, 480) == 4 * (768 + 129 + 480)
    t, by = counts.ode_chunk_bound(3, 256, 128, 480, 16384, 256, True)
    assert by == "operations" and t == pytest.approx(16384 * 256 * 10144 / 67e12)
    assert t * 1e3 == pytest.approx(0.635030, abs=5e-7)  # PERF.md's B1 bound
    nbytes = 2 * 16384 * (4 * (128 + 512 + 1) + 1) + 4 * (768 + 129 + 480)
    assert counts.bound(nbytes, 0) == (nbytes / 3.35e12, "bytes")


def test_counts_by_hand_for_uf250():
    lay = formulas.layout(uf())
    assert (lay.K, lay.Mp, lay.Np, lay.nnz) == (3, 1152, 256, 3195)
    assert counts.ode_step_ops(3195, 256, 1152, True) == 60213
    assert counts.ode_step_ops(480, 128, 256, False) == 2 * 10144 + 6 * 128 + 20 * 256
    assert counts.stoch_step_ops(480, 128, 256) == 5 * 480 + 3 * 256 + 14 * 128
    t, by = counts.stoch_chunk_bound(3, 256, 128, 480, 16384, 64)
    assert by == "operations" and t == pytest.approx(16384 * 64 * 4960 / 67e12)
    assert t * 1e3 == pytest.approx(0.077626, abs=5e-7)  # PERF.md's B3 bound


def test_dimacs_reader_and_oracle():
    f = formulas.read_dimacs("c x\np cnf 5 3\n1 -3 0\n\n2 5 0\n-1 0\n%\n4 0\n")
    assert f.varnum == 5 and f.var.shape == (3, 2)
    n = formulas.normalized(f)
    assert n.var.tolist() == [[0, 2], [1, 3], [0, -1]] and n.varnum == 5
    a = np.zeros((2, 5), dtype=bool)
    a[0, [1]] = True  # x1 false, x2 true: 1 -3 holds by -3, 2 5 by 2, -1 by -1
    a[1, [0, 1]] = True
    assert formulas.satisfied(n, a).tolist() == [True, False]


def test_the_instance_stream_is_seeded_planted_and_distinct():
    a = formulas.planted_ksat(np.random.default_rng(7), 8, 250, 1065)
    b = formulas.planted_ksat(np.random.default_rng(7), 8, 250, 1065)
    c = formulas.planted_ksat(np.random.default_rng(8), 8, 250, 1065)
    assert np.array_equal(a.var, b.var) and np.array_equal(a.neg, b.neg)
    assert not np.array_equal(a.var, c.var)
    assert len({x.tobytes() for x in a.var}) == 8
    s = np.sort(a.var, axis=2)
    assert (s[:, :, 1:] != s[:, :, :-1]).all() and a.var.min() >= 0 and a.var.max() < 250
    # the hidden assignment is not kept, but each instance is satisfiable:
    # every clause agrees with one assignment, the one drawn first
    hidden = np.random.default_rng(7).integers(0, 2, size=(8, 250)).astype(bool)
    for i in range(8):
        f = formulas.Formula(a.var[i], a.neg[i], 250)
        assert formulas.satisfied(f, hidden[i:i + 1])[0]


def _port(f):
    from odesat_tpu_torch.cnf.formula import CNFFormula, Literal

    return CNFFormula([tuple(Literal(int(v), bool(n)) for v, n in zip(vs, ns) if v >= 0)
                       for vs, ns in zip(f.var.tolist(), f.neg.tolist())], f.varnum)


@pytest.mark.parametrize("which", ["aim", "uf", "mixed"])
def test_layout_is_the_programs_compile(which):
    from odesat_tpu_torch.models.ode import compile_for_config
    from odesat_tpu_torch.ops.fused_chunk import chunk_tables
    from odesat_tpu_torch.utils.config import SolverConfig

    if which == "mixed":
        f = formulas.normalized(formulas.read_dimacs(
            "p cnf 6 5\n1 2 0\n-2 3 -4 0\n5 6 0\n-1 -6 3 0\n4 -5 0\n"))
    else:
        f = aim() if which == "aim" else uf()
    lay = formulas.layout(f)
    fa = compile_for_config(_port(f), SolverConfig())
    on = fa.lit_mask > 0
    assert np.array_equal(on, lay.lit_on)
    assert np.array_equal(np.where(on, fa.lit_var, 0), lay.lit_var)
    assert np.array_equal((fa.sign < 0) & on, lay.negated)
    assert np.array_equal(fa.xs_init, lay.xs_init)
    assert np.array_equal(fa.clause_mask > 0, lay.clause_on)
    t = chunk_tables(fa)
    for v in range(lay.Np):
        listed = lay.occ[v][lay.occ[v] < lay.K * lay.Mp]
        assert listed.tolist() == t.occ_slot[t.occ_ptr[v]:t.occ_ptr[v + 1]].tolist()
    from odesat_tpu_torch.utils.config import zeta_for_density

    assert lay.zeta == zeta_for_density(fa.density) and lay.nnz == int(on.sum())


@pytest.mark.parametrize("dt", [0.01, None])
@pytest.mark.parametrize("which", ["aim", "uf"])
def test_reference_equals_b1s_plain_version_bit_for_bit(which, dt):
    """The program's B1 plain version (what its kernel equals on the card)
    and the reference, from the same draw, 70 steps in chunks of 32."""
    from odesat_tpu_torch.models.ode import compile_for_config, init_state
    from odesat_tpu_torch.ops.fused_chunk import make_fused_chunk
    from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig

    f = aim() if which == "aim" else uf()
    cfg = SolverConfig(ode=ODEConfig(step_size=dt, dv_strategy="fused"), batch_size=6)
    fa = compile_for_config(_port(f), cfg)
    state = init_state(fa, 6, torch.Generator().manual_seed(99), cfg.ode, "cpu")
    out = make_fused_chunk(fa, cfg.ode.resolve_zeta(fa.density), cfg.ode, 70, "cpu")(state)
    lay = formulas.layout(f)
    tab = reference.Tables(lay, "cpu")
    v0 = reference.initial_v(99, 6, lay.Np, "cpu")
    assert torch.equal(v0, state.v)
    run = reference.Runner(tab, reference.Integrator(dt), 6, 32)
    run.set(reference.start(tab, v0))
    run.advance(70)
    for a, b in zip(out, run.state):
        assert torch.equal(a, b)


def test_reference_loads_another_formula_of_the_shape_in_place():
    f1, f2 = uf(1), uf(2)
    l1, l2 = formulas.layout(f1), formulas.layout(f2)
    d = max(l1.occ.shape[1], l2.occ.shape[1]) + 3  # padded wider than either needs
    v0 = reference.initial_v(3, 4, l1.Np, "cpu")
    shared = reference.Tables(l1, "cpu", d)
    run = reference.Runner(shared, reference.Integrator(0.01), 4, 16)
    results = []
    for lay in (l1, l2):
        shared.load(lay)
        run.set(reference.start(shared, v0))
        run.advance(40)
        own = reference.Runner(reference.Tables(lay, "cpu"), reference.Integrator(0.01), 4, 16)
        own.set(reference.start(own.tab, v0))
        own.advance(40)
        assert all(torch.equal(a, b) for a, b in zip(run.state, own.state))
        results.append(run.state.v.clone())
    assert not torch.equal(results[0], results[1])


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                got = _imports(os.path.join(dirpath, f))
                assert not got & {"jax", "jaxlib", "flax", "odesat_tpu"}, f


def test_the_yardstick_imports_nothing_of_the_program():
    for f in ("reference.py", "formulas.py", "counts.py"):
        assert "odesat_tpu_torch" not in _imports(os.path.join(BENCH, f)), f
    code = ("import sys; sys.path.insert(0, %r); import bench_port.reference, "
            "bench_port.formulas, bench_port.counts; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('odesat_tpu_torch', 'odesat_tpu', 'jax', 'jaxlib', 'flax')); print(bad)" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_guard_compares_top_level_names_whole(monkeypatch):
    from bench_port import harness

    base = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "odesat_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert set(harness.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "odesat_tpu.models", object())
    assert set(harness.forbidden_modules()) - base == {"odesat_tpu.models"}
