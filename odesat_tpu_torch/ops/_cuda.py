"""Build the package's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), for
Hopper only (``sm_90a``). The library is keyed on a hash of the source
and the compiler flags, the way ``odesat_tpu/native`` keys its g++ build,
and cached under ``csrc/_build/`` (listed in ``.gitignore``), so a process
reuses an earlier process's build of the same source.

Unlike the JAX package's native loader there is no silent fallback: a
missing ``nvcc``, a failed compile or a failed load raises, because a
kernel that quietly does not run would make every measurement a lie.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "_build")

# --fmad=false: no contraction of a*b+c into FMA, so the kernel rounds at
# the same points as its plain torch version (ops/fused_chunk.py).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: dict = {}  # source name -> (ctypes.CDLL, build record)


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of odesat_tpu_torch "
        "are built from source at first use"
    )


def _source_key(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless a build of the same source and
    flags exists. Returns ``{"path", "seconds", "cached", "log"}``; the
    log holds ``-Xptxas -v``'s registers and shared memory per kernel."""
    src = os.path.join(_CSRC, f"{name}.cu")
    key = _source_key(src)
    lib = os.path.join(BUILD_DIR, f"lib{name}-{key}.so")
    log_path = lib + ".log"
    if os.path.exists(lib):
        log = ""
        if os.path.exists(log_path):
            with open(log_path, encoding="utf-8") as fh:
                log = fh.read()
        return {"path": lib, "seconds": 0.0, "cached": True, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    # unique temporary name, then an atomic rename: concurrent builds of
    # the same source never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {src} (exit {proc.returncode}):\n{log}")
    with open(log_path, "w", encoding="utf-8") as fh:
        fh.write(log)
    os.replace(tmp, lib)
    return {"path": lib, "seconds": seconds, "cached": False, "log": log}


def load(name: str, declare) -> tuple:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process.
    ``declare(lib)`` sets ``argtypes``/``restype`` of every entry point.
    Returns ``(lib, build_record)``."""
    hit = _LOADED.get(name)
    if hit is not None:
        return hit
    record = build(name)
    lib = ctypes.CDLL(record["path"])
    declare(lib)
    _LOADED[name] = (lib, record)
    return lib, record
