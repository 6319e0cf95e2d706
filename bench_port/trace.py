"""The traced window: ``torch.profiler`` over the window (the host's torch
operations and the card's kernels, copies and fills), the benchmark's own
spans as ``record_function`` ranges, and what the per-layer readers take
from it: device time by kernel, the card's busy time (the union of its
activity), idle gaps named by what the host was doing.

The trace is written as a chrome trace into ``TMPDIR``, read, and deleted.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import re
import tempfile
from contextlib import nullcontext

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


def profiler(on: bool):
    """A profiler of the host and the card, or nothing."""
    if not on:
        return nullcontext()
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span(name: str, on: bool):
    if not on:
        return nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def merged(intervals) -> list:
    """Sorted, disjoint [start, end] intervals covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """One traced window, times in microseconds of the profiler's clock."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        wins = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not wins:
            raise RuntimeError("the trace holds no window span")
        w = wins[0]
        self.start, self.end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = [(a, a + float(e["dur"]), e["name"]) for e in xs
                       if e.get("cat") in DEVICE_CATS and (a := float(e["ts"])) < self.end
                       and a + float(e["dur"]) > self.start]
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in xs if e.get("cat") in HOST_CATS and e is not w]
        self.busy = merged([[max(a, self.start), min(b, self.end)] for a, b, _ in self.device])
        self._starts = [a for a, _ in self.busy]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_s(self, a: float | None = None, b: float | None = None) -> float:
        """Seconds in which the card ran something, within [a, b] (the
        window by default)."""
        a = self.start if a is None else a
        b = self.end if b is None else b
        if b <= a:
            return 0.0
        i = max(bisect.bisect_right(self._starts, a) - 1, 0)
        total = 0.0
        while i < len(self.busy) and self.busy[i][0] < b:
            lo, hi = max(self.busy[i][0], a), min(self.busy[i][1], b)
            total += max(hi - lo, 0.0)
            i += 1
        return total * 1e-6

    def spans(self, name: str) -> list:
        """The benchmark's spans of that name: (start, end), in order."""
        return sorted((a, b) for a, b, n in self.host if n == name)

    def kernels(self, pattern: str) -> tuple:
        """(launches, seconds) of the device events whose name matches."""
        rx = re.compile(pattern)
        hits = [(b - a) for a, b, n in self.device if rx.search(n)]
        return len(hits), sum(hits) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by = {}
        for a, b, n in self.device:
            by[n] = by.get(n, 0.0) + (min(b, self.end) - max(a, self.start)) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[name, seconds]: the card's idle time in the window, each gap
        given to the innermost host event at its middle (a torch
        operation, a CUDA call, or the benchmark's span when the host ran
        Python outside both), summed by that name, the largest first."""
        edges = [self.start] + [x for ab in self.busy for x in ab] + [self.end]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        host = sorted(self.host)
        by, open_, j = {}, [], 0
        for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (a + b) / 2
            while j < len(host) and host[j][0] <= mid:
                heapq.heappush(open_, (host[j][1], -host[j][0], host[j][2]))
                j += 1
            while open_ and open_[0][0] < mid:
                heapq.heappop(open_)
            name = min(open_, key=lambda e: e[1])[2] if open_ else "outside any span"
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:top]]


def read(prof) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events)
