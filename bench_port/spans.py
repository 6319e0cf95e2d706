"""The program's stage spans in a traced window, as the per-layer readers
of a solve's host work take them.

``odesat_tpu_torch`` opens a ``record_function`` span at each stage of a
solve while a profiler records (``utils/logging.span``): ``ode.solve``
around the call, and inside it the stages of :data:`STAGES`. A stage's
**card-idle self time** is the part of its spans that no other stage span
nested inside covers (a runner built inside ``loop.decide`` is
``ode.build``'s, not the decision's), less the card's busy time in that
part; a reader sums it over the window and divides by the window's
solves, in ms. On a program without the spans nothing is read.
"""

from __future__ import annotations

import bisect
import importlib
import weakref

from bench_port.trace import merged

SOLVE = "ode.solve"
STAGES = ("ode.compile", "ode.state", "ode.build", "device_loop.capture",
          "device_loop.dispatch", "loop.decide", "ode.readout", "ode.release")

_SPLITS = weakref.WeakKeyDictionary()
_NOTED = weakref.WeakSet()


def present(*keys) -> tuple:
    """Those of the counters ``keys`` (``"module:name"``) that the program
    has: a reader asks only for these, so a program without a counter
    reads nothing rather than failing."""
    out = []
    for key in keys:
        mod, name = key.split(":")
        try:
            if hasattr(importlib.import_module(mod), name):
                out.append(key)
        except ImportError:
            pass
    return tuple(out)


def _window(trace, name) -> list:
    return [(a, b) for a, b in trace.spans(name) if a >= trace.start and b <= trace.end]


def _idle_s(trace, parts) -> float:
    return sum((b - a) * 1e-6 - trace.busy_s(a, b) for a, b in parts)


def split(trace) -> dict:
    """``{name: (spans, card-idle self seconds)}`` for every stage of
    :data:`STAGES` over the window, and for :data:`SOLVE` its spans and
    their whole card-idle seconds; computed once a trace."""
    got = _SPLITS.get(trace)
    if got is not None:
        return got
    every = sorted((a, b, n) for n in STAGES for a, b in _window(trace, n))
    starts = [a for a, _, _ in every]
    out = {}
    for i, (a, b, name) in enumerate(every):
        # stage spans nested inside this one: they start within it (one
        # client thread, so spans nest or are disjoint) and end inside it
        inner = []
        for k in range(bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)):
            c, d, _ = every[k]
            if k != i and d <= b and (c, d) != (a, b):
                inner.append([c, d])
        parts, at = [], a
        for c, d in merged(inner):
            if c > at:
                parts.append((at, c))
            at = max(at, d)
        if b > at:
            parts.append((at, b))
        n, s = out.get(name, (0, 0.0))
        out[name] = (n + 1, s + _idle_s(trace, parts))
    solves = _window(trace, SOLVE)
    out[SOLVE] = (len(solves), _idle_s(trace, solves))
    _SPLITS[trace] = out
    return out


def stage_ms(ctx, metric: str, names: tuple):
    """The card-idle self time of the stages ``names``, ms a solve, or None
    (with a note) when the trace holds no span of any of them. The first
    reading of a trace notes how much of ``ode.solve``'s card-idle time the
    stages cover."""
    if ctx.trace is None:
        return None
    got = split(ctx.trace)
    if not any(got.get(n, (0, 0.0))[0] for n in names):
        ctx.note(f"{metric}: no {' or '.join(names)} span in the trace; not read")
        return None
    if ctx.trace not in _NOTED:
        _NOTED.add(ctx.trace)
        solves, idle = got[SOLVE]
        staged = sum(s for n, (_, s) in got.items() if n != SOLVE)
        bench = _idle_s(ctx.trace, _window(ctx.trace, "bench.solve"))
        per = 1e3 / max(len(ctx.records), 1)
        ctx.note(f"stages: {solves} ode.solve spans, card-idle ms a solve: inside ode.solve "
                 f"{per * idle:.3f}, in its stages {per * staged:.3f} "
                 f"({100.0 * staged / idle if idle > 0 else 0.0:.1f}%), outside them "
                 f"{per * (idle - staged):.3f}; in bench.solve outside ode.solve "
                 f"{per * (bench - idle):.3f}; by stage "
                 + ", ".join(f"{n} {per * s:.3f} ({c})" for n, (c, s) in got.items()
                             if n != SOLVE))
    return 1e3 * sum(got.get(n, (0, 0.0))[1] for n in names) / len(ctx.records)


def spans_match(ctx, metric: str, name: str, key: str) -> bool:
    """Whether the window's ``name`` spans are as many as the program's
    counter ``key`` counted over it (False, with a note, when the counter
    is missing or they differ: the trace missed some, or the program has
    no such span)."""
    n = len(_window(ctx.trace, name))
    if key not in ctx.counters or n != ctx.counters[key]:
        ctx.note(f"{metric}: {n} {name} spans in the trace, {ctx.counters.get(key)} counted "
                 f"({key}); not read")
        return False
    return True
