"""ctypes bindings for the native host runtime, built from the port's own
copy of the JAX package's C++ source.

The port of ``odesat_tpu.native``: ``csrc/odesat_native.cc`` is a copy of
``odesat_tpu/native/odesat_native.cc`` (DIMACS parser, preprocessor and
the single-core CPU baseline solver), compiled with the same g++ flags
and never imported through ``odesat_tpu`` (which would import jax). The library goes into ``odesat_tpu_torch/csrc/_build/``
(listed in ``.gitignore``), keyed on a hash of the source, the flags and
the host's CPU, since ``-march=native`` ties a build to the CPU that made
it.

This is host code, not a kernel: when g++ is missing or the build fails,
:func:`is_available` is False and callers use the Python twins
(``odesat_tpu_torch.cnf`` and ``odesat_tpu_torch.preprocess``), as the
JAX package does. :func:`build_info` says which happened.

The trace travels as the library's all-u32 little-endian stream: per
step ``kind, var, n_clauses, {len, lits...}*`` with ``kind`` 0 for a
variable elimination and 1 for a blocked clause, literals encoded
``2*var + negated``, clauses and literals in ascending order.
:func:`encode_trace` writes a Python trace in that form, so the two
preprocessors can be compared byte for byte.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import time

import numpy as np

from odesat_tpu_torch.cnf.formula import CNFFormula, Literal
from odesat_tpu_torch.preprocess.trace import (
    BlockedClauseElimination,
    SimplificationTrace,
    VariableElimination,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "odesat_native.cc")
BUILD_DIR = os.path.join(_PKG, "csrc", "_build")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_info: dict = {}


def _host_id() -> str:
    """What ``-march=native`` depends on: the machine and its CPU model."""
    model = ""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as fh:
            for line in fh:
                if line.startswith(("model name", "flags")):
                    model += line
    except OSError:
        pass
    return platform.machine() + "\n" + model


def _key() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_host_id().encode())
    return h.hexdigest()[:16]


def _build() -> dict:
    """Compile ``SOURCE`` unless a build with the same key exists."""
    lib = os.path.join(BUILD_DIR, f"libodesat_native-{_key()}.so")
    if os.path.exists(lib):
        return {"path": lib, "seconds": 0.0, "cached": True}
    os.makedirs(BUILD_DIR, exist_ok=True)
    # unique temporary name, then an atomic rename: concurrent builds
    # (test workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": lib, "seconds": seconds, "cached": False}


def _declare(lib) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.odesat_free.argtypes = [ctypes.c_void_p]
    lib.odesat_parse_dimacs.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(i32p), ctypes.POINTER(i64p),
        i64p, i64p,
    ]
    lib.odesat_preprocess.argtypes = [
        i32p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(i32p), ctypes.POINTER(i64p), i64p, i64p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), i64p,
    ]
    lib.odesat_baseline_steps_per_sec.restype = ctypes.c_double
    lib.odesat_baseline_steps_per_sec.argtypes = [
        i32p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_uint64,
    ]


def _load():
    global _lib
    with _lock:
        if _lib is not None or _info:
            return _lib
        try:
            record = _build()
            lib = ctypes.CDLL(record["path"])
            _declare(lib)
        except Exception as e:  # noqa: BLE001 -- any failure => Python twins
            _info.update(available=False, error=f"{type(e).__name__}: {e}")
            return None
        _info.update(available=True, **record)
        _lib = lib
        return _lib


def is_available() -> bool:
    """Build (at first use) and load the library; False if that fails."""
    return _load() is not None


def build_info() -> dict:
    """``{"available", "path", "seconds", "cached"}`` after a successful
    build, ``{"available": False, "error"}`` after a failed one."""
    _load()
    return dict(_info)


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_info.get('error')}")
    return lib


def _encode(formula: CNFFormula):
    """Formula -> (flat encoded literals, offsets). lit = (var<<1)|neg."""
    clauses = formula.clauses
    lits = [(lit.variable << 1) | lit.is_negated for c in clauses for lit in c]
    offsets = np.zeros(len(clauses) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in clauses], out=offsets[1:])
    return np.asarray(lits, dtype=np.int32), offsets


def _decode(lits: np.ndarray, offsets: np.ndarray, varnum: int) -> CNFFormula:
    # each distinct literal is built once; the clause tuples are carved
    # off one iterator (the JAX package's decode, measured there)
    from itertools import islice, repeat, starmap

    lits_l = lits.tolist()
    lut = {e: Literal(e >> 1, bool(e & 1)) for e in set(lits_l)}
    mapped = iter(list(map(lut.__getitem__, lits_l)))
    widths = np.diff(offsets).tolist()
    clauses = list(map(tuple, starmap(islice, zip(repeat(mapped), widths))))
    return CNFFormula(clauses, varnum)


def _take(lib, ptr, n, dtype) -> np.ndarray:
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n else np.empty(0, dtype)
    lib.odesat_free(ptr)
    return arr


def parse_dimacs_native(text: str) -> CNFFormula:
    """The native DIMACS parser; the same formula as ``cnf.parse_dimacs``."""
    lib = _require()
    data = text.encode("utf-8")
    lits_p = ctypes.POINTER(ctypes.c_int32)()
    offs_p = ctypes.POINTER(ctypes.c_int64)()
    n_clauses = ctypes.c_int64()
    varnum = ctypes.c_int64()
    rc = lib.odesat_parse_dimacs(
        data, len(data), ctypes.byref(lits_p), ctypes.byref(offs_p),
        ctypes.byref(n_clauses), ctypes.byref(varnum),
    )
    if rc != 0:
        raise ValueError(f"native DIMACS parse failed (rc={rc})")
    offsets = _take(lib, offs_p, n_clauses.value + 1, np.int64)
    lits = _take(lib, lits_p, int(offsets[-1]), np.int32)
    formula = _decode(lits, offsets, varnum.value)
    if varnum.value < 0:  # no header: count used variables (reference fallback)
        formula.varnum = len(formula.variable_set())
    return formula


def _code(lit: Literal) -> int:
    return (lit.variable << 1) | int(lit.is_negated)


def encode_trace(trace: SimplificationTrace) -> bytes:
    """The trace as the library's u32 stream (module docstring), clauses
    and literals in ascending order, as the library writes them."""
    words: list = []
    for step in trace.steps:
        if isinstance(step, VariableElimination):
            kind, clauses = 0, step.modified_pos_clauses
        else:
            kind, clauses = 1, (step.clause,)
        coded = sorted(sorted(_code(lit) for lit in c) for c in clauses)
        words += [kind, step.variable, len(coded)]
        for c in coded:
            words.append(len(c))
            words += c
    return np.asarray(words, dtype="<u4").tobytes()


def decode_trace(blob: bytes) -> SimplificationTrace:
    """The inverse of :func:`encode_trace`, for any blob the library writes."""
    w = np.frombuffer(blob, dtype="<u4").tolist()
    trace = SimplificationTrace()
    lut: dict = {}

    def lit(e):
        lo = lut.get(e)
        if lo is None:
            lo = lut[e] = Literal(e >> 1, bool(e & 1))
        return lo

    pos = 0
    while pos < len(w):
        kind, var, n_clauses = w[pos], w[pos + 1], w[pos + 2]
        pos += 3
        clauses = []
        for _ in range(n_clauses):
            n = w[pos]
            clauses.append(frozenset(map(lit, w[pos + 1 : pos + 1 + n])))
            pos += 1 + n
        if kind == 0:
            trace.add(VariableElimination(var, frozenset(clauses)))
        else:
            (only,) = clauses
            trace.add(BlockedClauseElimination(var, only))
    return trace


def preprocess_native_raw(formula: CNFFormula, target_ratio: float = 7.0):
    """Native preprocessing; returns ``(reduced formula, trace blob)``."""
    lib = _require()
    lits, offsets = _encode(formula)
    out_lits = ctypes.POINTER(ctypes.c_int32)()
    out_offs = ctypes.POINTER(ctypes.c_int64)()
    out_m = ctypes.c_int64()
    out_varnum = ctypes.c_int64()
    trace_p = ctypes.POINTER(ctypes.c_uint8)()
    trace_len = ctypes.c_int64()
    rc = lib.odesat_preprocess(
        lits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        formula.num_clauses, formula.varnum, float(target_ratio),
        ctypes.byref(out_lits), ctypes.byref(out_offs), ctypes.byref(out_m),
        ctypes.byref(out_varnum), ctypes.byref(trace_p), ctypes.byref(trace_len),
    )
    if rc != 0:
        raise ValueError(f"native preprocess failed (rc={rc})")
    offs = _take(lib, out_offs, out_m.value + 1, np.int64)
    flat = _take(lib, out_lits, int(offs[-1]), np.int32)
    blob = _take(lib, trace_p, trace_len.value, np.uint8).tobytes()
    return _decode(flat, offs, out_varnum.value), blob


def preprocess_native(formula: CNFFormula, target_ratio: float = 7.0):
    """Native preprocessing; the same ``(reduced formula, trace)`` as the
    Python path of ``odesat_tpu_torch.preprocess.preprocess_formula``."""
    reduced, blob = preprocess_native_raw(formula, target_ratio)
    return reduced, decode_trace(blob)


def baseline_steps_per_sec(
    formula: CNFFormula, steps: int = 20000, dt: float = 0.01, zeta: float = 0.001, seed: int = 1
) -> float:
    """Single-core CPU ODE throughput (steps/s) on a *normalized* formula:
    the library's own Euler solver, the measured stand-in for the unrunnable
    Rust reference (JAX ``odesat_tpu/native/__init__.py:267``). Raises
    RuntimeError when the library is unavailable."""
    lib = _require()
    lits, offsets = _encode(formula)
    return lib.odesat_baseline_steps_per_sec(
        lits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        formula.num_clauses, formula.varnum, steps, dt, zeta, seed,
    )
