"""The port's library surface: the JAX package's exported API, resolved
lazily (odesat_tpu_torch/__init__.py and each subpackage's ``__init__``).

* Every name in the ``__all__`` of ``odesat_tpu``, ``.models``, ``.ops``,
  ``.parallel`` and ``.utils`` resolves in the port's counterpart, except
  exactly the names of ``odesat_tpu_torch.NOT_OFFERED``, which raise with
  their reason.
* ``import odesat_tpu_torch`` imports no torch, jax or odesat_tpu; importing
  every module of the port imports no jax or odesat_tpu.
* ``Throughput`` counts as JAX's does.
* The entry points run on the card by default: ``device="cuda"``, and
  without a card a call that leaves ``device`` out raises (no CPU
  fallback).
* ``odesat_tpu_torch/examples/library_usage.py --device cpu`` runs on
  easy.cnf and verifies.
"""

import importlib
import inspect
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import odesat_tpu_torch  # noqa: E402
from odesat_tpu.utils.logging import Throughput as JThroughput  # noqa: E402
from odesat_tpu_torch.utils.logging import Throughput  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["", ".models", ".ops", ".parallel", ".utils"]


def _unresolved(sub: str) -> set:
    jax_pkg = importlib.import_module(f"odesat_tpu{sub}")
    port = importlib.import_module(f"odesat_tpu_torch{sub}")
    missing = set()
    for name in jax_pkg.__all__:
        try:
            getattr(port, name)
        except AttributeError:
            missing.add(name)
    return missing


@pytest.mark.parametrize("sub", PACKAGES)
def test_jax_exports_resolve_in_the_port(sub):
    """Each JAX name resolves in the port's package of the same path, or is
    one the port lists as not offered; the port exports JAX's names."""
    missing = _unresolved(sub)
    assert missing <= set(odesat_tpu_torch.NOT_OFFERED), missing
    port = importlib.import_module(f"odesat_tpu_torch{sub}")
    jax_pkg = importlib.import_module(f"odesat_tpu{sub}")
    assert set(port.__all__) == set(jax_pkg.__all__) - missing


def test_the_names_not_offered_are_exactly_the_listed_ones():
    missing = set().union(*(_unresolved(sub) for sub in PACKAGES))
    assert missing == set(odesat_tpu_torch.NOT_OFFERED)
    with pytest.raises(AttributeError, match="not offered by the port .the onehot"):
        odesat_tpu_torch.ops.build_onehot


def test_renamed_exports_keep_jax_meaning():
    """JAX's names for the port's functions of other names."""
    from odesat_tpu_torch.ops import rhs_kernel, stoch_chunk
    from odesat_tpu_torch.parallel import sharded

    assert odesat_tpu_torch.ops.make_pallas_rhs is rhs_kernel.make_rhs_kernel
    assert odesat_tpu_torch.ops.make_fused_stoch_chunk is stoch_chunk.make_fused_stoch_chunk
    assert odesat_tpu_torch.parallel.simulate_batch_sharded is sharded.simulate_batch_sharded
    assert odesat_tpu_torch.ode is odesat_tpu_torch.models.ode


def _imports(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.split()


def test_importing_the_package_imports_no_torch_jax_or_odesat_tpu():
    seen = _imports("import sys, odesat_tpu_torch; "
                    "print(*sorted(m for m in ('torch', 'jax', 'odesat_tpu') if m in sys.modules))")
    assert seen == []


def test_importing_every_module_imports_no_jax_or_odesat_tpu():
    seen = _imports(
        "import importlib, pkgutil, sys, odesat_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(odesat_tpu_torch.__path__, "
        "'odesat_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in odesat_tpu_torch.__all__:\n"
        "    getattr(odesat_tpu_torch, name)\n"
        "print(len(names), *sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'odesat_tpu' or m.startswith('odesat_tpu.')))")
    assert int(seen[0]) > 40, seen  # every module was walked
    assert seen[1:] == []


def test_throughput_counts_as_jax_does(monkeypatch):
    clock = iter([10.0, 10.0, 12.5, 12.5, 14.0, 14.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    ours, theirs = Throughput(8), JThroughput(8)
    for t in (ours, theirs):
        t.add(3)
        t.add(7)
    assert ours.steps == theirs.steps == 10
    assert ours.rate() == theirs.rate() == 8 * 10 / 2.5
    ours.add(5)
    theirs.add(5)
    assert ours.rate() == theirs.rate() == 8 * 15 / 4.0


def test_library_usage_example_verifies_on_the_cpu():
    # two threads, as tests/torch_parity.py gives this process, so that the
    # example does not take every core from the other test workers
    out = subprocess.run(
        [sys.executable, os.path.join("odesat_tpu_torch", "examples", "library_usage.py"),
         os.path.join("tests", "data", "easy.cnf"), "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    for line in ("verified: True", "stoch solved: True", "sharded solve: True",
                 "clause-sharded solve: True"):
        assert line in out.stdout, out.stdout


def _entry_calls(data_dir):
    """The facade's functions that take a ``device``, with solve_exact and
    the mesh's batched solve, each with the arguments of a library call
    that leaves ``device`` out."""
    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file
    from odesat_tpu_torch.parallel.sharded import simulate_batch_sharded
    from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig
    from odesat_tpu_torch.utils.tts import solve_exact

    formula = normalize_cnf_variables(parse_dimacs_file(os.path.join(data_dir, "small.cnf")))[1]
    fa = compile_formula(formula)
    top = {name for name in odesat_tpu_torch.__all__
           if callable(getattr(odesat_tpu_torch, name))
           and "device" in inspect.signature(getattr(odesat_tpu_torch, name)).parameters}
    assert top == {"simulate", "simulate_batch", "search", "hybrid_search"}, top
    return {
        "simulate": (odesat_tpu_torch.simulate, (formula,)),
        "simulate_batch": (odesat_tpu_torch.simulate_batch, (formula, SolverConfig())),
        "search": (odesat_tpu_torch.search, (formula,)),
        "hybrid_search": (odesat_tpu_torch.hybrid_search, (formula,)),
        "solve_exact": (solve_exact, (fa, ODEConfig(), 4, None, 16, 64)),
        "simulate_batch_sharded": (simulate_batch_sharded, (fa, SolverConfig(), None)),
    }


@pytest.mark.parametrize("name", ["simulate", "simulate_batch", "search", "hybrid_search",
                                  "solve_exact", "simulate_batch_sharded"])
def test_entry_points_run_on_the_card_by_default(data_dir, monkeypatch, name):
    """Each entry point's ``device`` defaults to "cuda" (by signature), and
    a JAX-style library call that leaves it out, on a machine without a
    card, raises the CLI's error before any work: no CPU fallback."""
    fn, args = _entry_calls(data_dir)[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"device='cuda' \(the default\) but torch finds no "
                                           r"CUDA device; pass device='cpu'"):
        fn(*args)
