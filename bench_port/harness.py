"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, the metrics, and the result's line.

Everything a cell needs is found by name. ``BENCHMARK.json`` (at the root
of the checkout) names the cell's configuration and traffic mix, and which
metrics it reports. ``configs/<config>.json`` is the configuration (what
formula, at what precision); ``traffic/<traffic>.json`` the mix (which
engine, the batch, the integrator, the budget, the check's sample and
limits); ``engines/<engine>.py`` drives the program; and
``metrics/<metric>.py`` (or, for ``name.suffix``, ``metrics/<name>.py``)
reads one metric from what the run recorded. A later cell, configuration
or metric is a new file and a new entry: no file here changes.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a window of their own under
``torch.profiler``. Both runs check their solves the same way.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field

from bench_port import trace as tracing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "odesat_tpu")  # top-level module names, whole


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as fh:
        return json.load(fh)


def workload_entry(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def end_to_end_of(manifest: dict, cell: str) -> list:
    return [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_of(manifest: dict, cell: str) -> list:
    moves = {m["name"] for m in end_to_end_of(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moves)]


def _module(path: str, name: str):
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<name up to its first dot>.py``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            return _module(path, "bench_port.metrics." + stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader for metric {name!r} under bench_port/metrics")


def _json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json"), encoding="utf-8") as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: str
    overrides: dict = field(default_factory=dict)


@dataclass
class Context:
    """What a metric's reader may read."""

    cell: Cell
    shapes: dict  # the formula's and the batch's shapes (engines' ``shapes()``)
    records: list  # the window's solves, in order (an engine's Record: t0, t1, steps, rows,
    #                solved, verified, loop_s)
    window_s: float  # the window's wall, host clock, the last solve included
    setup_s: float
    counters: dict  # "module:name" -> its change over the window
    trace: object = None  # trace.Trace of a traced run
    notes: list = field(default_factory=list)

    def note(self, line: str) -> None:
        self.notes.append(line)


def counter(key: str) -> float:
    mod, name = key.split(":")
    return getattr(importlib.import_module(mod), name)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, traffic: dict | None = None,
             t_start: float | None = None, manifest: dict | None = None) -> tuple:
    """Run cell ``name`` once. Returns ``(result, checks, notes)``: the
    result's JSON object, ``{number: (value, limit)}`` and lines for the
    log. ``overrides`` replaces fields of the program's ODE config (the
    control's runs), ``traffic`` fields of the traffic mix (the tests'
    sizes)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    manifest = manifest or load_manifest()
    entry = workload_entry(manifest, name)
    cell = Cell(name, _json("configs", entry["config"]),
                {**_json("traffic", entry["traffic"]), **(traffic or {})},
                int(seed), float(seconds), device, dict(overrides or {}))
    engine = importlib.import_module("bench_port.engines." + cell.traffic["engine"])
    metrics = per_layer_of(manifest, name) if trace else end_to_end_of(manifest, name)
    readers = {m["name"]: reader(m["name"]) for m in metrics}
    keys = sorted({k for r in readers.values() for k in getattr(r, "COUNTERS", ())})
    cuda = torch.device(device).type == "cuda"

    work = engine.Workload(cell)
    work.warm()
    if cuda:
        torch.cuda.synchronize()
    # what set-up made lives as long as the process: the collector need not
    # walk it again at every full collection inside the window
    gc.collect()
    gc.freeze()
    before = {k: counter(k) for k in keys}
    keep = int(cell.traffic["check"]["solves"])
    pick = random.Random(f"{cell.seed}/reservoir")
    records, kept = [], []
    with tracing.profiler(trace) as prof:
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        with tracing.span(tracing.WINDOW, trace):
            i = 0
            while i == 0 or time.perf_counter() - t0 < cell.seconds:
                req = work.request(i)
                with tracing.span("bench.solve", trace):
                    rec = work.solve(req, keep=True)
                # a reservoir drawn from the seed: each solve is kept with
                # the same chance, whatever the window's length
                if i < keep:
                    kept.append(rec)
                else:
                    slot = pick.randrange(i + 1)
                    drop = kept[slot] if slot < keep else rec
                    drop.assignment = drop.done = None
                    if slot < keep:
                        kept[slot] = rec
                records.append(rec)
                i += 1
        window_s = time.perf_counter() - t0
    counters = {k: counter(k) - before[k] for k in keys}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = tracing.read(prof) if trace else None
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = work.check(kept)
    ctx = Context(cell, work.shapes(), records, window_s, setup_s, counters, traced)
    ctx.note(f"set-up {setup_s:.3f} s, window {window_s:.3f} s ({len(records)} solves), "
             f"check {time.perf_counter() - t_check:.3f} s ({len(kept)} solves)")
    n = len(records)
    call = sum(r.t1 - r.t0 for r in records) / n
    loop = sum(r.loop_s for r in records) / n
    ctx.note(f"a solve, mean ms: the call and the oracle {1e3 * call:.3f}, its chunk loop "
             f"{1e3 * loop:.3f}, the rest of the call {1e3 * (call - loop):.3f}, between "
             f"calls {1e3 * (window_s / n - call):.3f}")
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    chips = int(entry["chips"])
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if traced is not None:
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(records),
              "failed": sum(work.failed(r) for r in records),
              "metrics": values, "device": dev}
    if traced is not None:
        result["breakdown"] = {"device_ops": traced.device_ops(), "idle_gaps": traced.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    bad = forbidden_modules()
    if bad:  # checked once the window has closed, in the process that prints
        raise ImportError("the run loaded " + ", ".join(bad))
    return result, checks, ctx.notes
