"""The port's ``native.baseline_steps_per_sec`` (the library's single-core
CPU Euler solver, the measured stand-in for the Rust reference) against
the JAX package's binding of the same C++ source: a positive, finite rate
on a normalized small formula, each keyword of JAX's signature taken, and
JAX's RuntimeError text when the library is unavailable."""

import inspect
import math
import os

import pytest

pytest.importorskip("torch")

from odesat_tpu import native as jnative  # noqa: E402
from odesat_tpu_torch import native  # noqa: E402
from odesat_tpu_torch.cnf import normalize_cnf_variables, parse_dimacs_file  # noqa: E402


def _small(data_dir):
    return normalize_cnf_variables(parse_dimacs_file(os.path.join(data_dir, "small.cnf")))[1]


def test_signature_equals_jax():
    assert (str(inspect.signature(native.baseline_steps_per_sec))
            == str(inspect.signature(jnative.baseline_steps_per_sec)))


@pytest.mark.parametrize("kw", [{}, dict(steps=500, dt=0.05, zeta=0.01, seed=7)])
def test_rate_is_positive_and_finite(data_dir, kw):
    if not native.is_available():
        pytest.skip(f"the native library does not build here: {native.build_info()}")
    rate = native.baseline_steps_per_sec(_small(data_dir), **kw)
    assert isinstance(rate, float) and math.isfinite(rate) and rate > 0


def test_unavailable_library_raises_jax_text(data_dir, monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(native, "_info", {"available": False, "error": "no g++"})
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_lib_error", "no g++")
    with pytest.raises(RuntimeError) as got:
        native.baseline_steps_per_sec(_small(data_dir))
    with pytest.raises(RuntimeError) as want:
        jnative.baseline_steps_per_sec(_small(data_dir))
    assert str(got.value) == str(want.value) == "native library unavailable: no g++"
