"""The installed port builds its kernels from the files it ships: every
file a build under ``odesat_tpu_torch/csrc/`` reads (each ``.cu``, each
header its ``#include "..."`` lines name, and the preprocessor's C++
source) matches a glob of ``pyproject.toml``'s package data, and the port
has its console script beside the JAX package's."""

import fnmatch
import os
import re
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "odesat_tpu_torch", "csrc")


def _pyproject():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        return tomllib.load(fh)


def _read_by_a_build():
    """The csrc files the kernels' builds and the native build read:
    every .cu, the headers their quoted includes name (and theirs), and
    odesat_native.cc."""
    todo = [f for f in os.listdir(CSRC) if f.endswith(".cu")] + ["odesat_native.cc"]
    seen = set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        with open(os.path.join(CSRC, name), encoding="utf-8") as fh:
            todo += re.findall(r'^\s*#include\s+"([^"]+)"', fh.read(), flags=re.M)
    return sorted(seen)


def test_every_file_a_build_reads_is_shipped():
    globs = _pyproject()["tool"]["setuptools"]["package-data"]["odesat_tpu_torch"]
    needed = _read_by_a_build()
    assert {"butterfly.cu", "tile.cuh", "bfly_tree.cuh", "ode_lanes.cuh", "bulk.cuh",
            "odesat_native.cc"} <= set(needed)
    for name in needed:
        assert os.path.isfile(os.path.join(CSRC, name)), name
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), (name, globs)


def test_the_port_has_its_console_script():
    scripts = _pyproject()["project"]["scripts"]
    assert scripts["odesat-tpu-torch"] == "odesat_tpu_torch.cli:main"
    assert scripts["odesat-tpu"] == "odesat_tpu.cli:main"
    from odesat_tpu_torch import cli

    assert callable(cli.main)
