"""The scan tier's chunk on the card: ``chunk_steps`` single steps of a step
function (``models/ode.make_step_fn``: the twin's ``gather`` or
``segment_sum`` RHS, or B10 with the torch update), captured once as a CUDA
graph, and its plain version, the loop of steps.

Replaces the jitted ``lax.scan`` chunk of ``odesat_tpu/models/ode.py:414-423``
(``make_chunk_runner``'s scan path), which JAX compiles into one program and
runs inside the ``lax.while_loop`` of ``:505-538``. Eager PyTorch launches
each of a step's kernels from Python (about 15 small ones around each RHS
pass), so a host-paced step leaves the card idle most of the time; the graph
launches them all from the card.

Design: at its first call for a batch shape, dtype and formula tensors, a
runner captures the step with ``torch.cuda.CUDAGraph``: a graph of up to
:data:`MAX_GRAPH_STEPS` calls, which a longer chunk runs over and over,
and one of the rest. The graphs read the state from fixed buffers and
write it back into them (the buffers are allocated outside the graphs'
pool; the step's temporaries live in the pool and are dead when a replay
ends). After that a call is copy-in, replays, copy-out. Every live graph of
every runner on a device shares one memory pool (:func:`graph_pool`): only
temporaries live there, so graphs of other chunk lengths reuse the same
bytes, which matters at full width, where a step's temporaries are tens of
GB. Graphs that share the pool must never run at the same time: every
replay and dispatch is queued on the caller's current stream. The step must
be capture-safe: no tensor made from a Python number, nothing read back to
the host, no branch on a tensor (``make_step_fn`` builds its constants and
tables ahead on the runner's device).

The runner is a ``device_loop.KernelChunk``, so the multi-chunk runner takes
it to the device loop (``ops/device_loop.py``): the loop runs on the
runner's buffers, and its WHILE node's body is the chunk's graphs as child
graph nodes, then a stop kernel that reduces ``done`` into the loop's stop
word.

Counts: :data:`launches` grows by one for every chunk a captured graph runs
(a replay, or a chunk of a device-loop dispatch). A kernel the step launches
through a counted wrapper (B10's ``rhs_kernel.launches``) counts while the
graph is captured, when nothing runs; the runner takes those counts back and
adds them once for every chunk that runs.

What bounds it: the step's own kernels (a step's bytes: v, xs and xl read
and written, the derivatives written and read once); the graph removes the
host between them.

The plain version is the loop of steps itself, which a CPU state runs. There
is no fallback on the card: a step that cannot be captured raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
import time
import weakref
from typing import Callable, NamedTuple

import torch

from odesat_tpu_torch.ops import device_loop, rhs_kernel
from odesat_tpu_torch.ops.device_loop import KernelChunk
from odesat_tpu_torch.ops.fused_chunk import cuda_device
from odesat_tpu_torch.utils.logging import logger

# Chunks run through a captured graph in this process: direct replays and
# the chunks of device-loop dispatches. A plain integer that callers may
# reset.
launches = 0
# Seconds spent capturing and instantiating graphs in this process (each
# capture also logs its own); a plain number that callers may reset.
capture_seconds = 0.0

_POOLS: dict = {}  # device -> (the graph memory pool its scan chunks share, its graphs)
_STREAMS: dict = {}  # device -> the side stream captures run on


def graph_pool(device: torch.device):
    """The graph memory pool the scan chunks of ``device`` share, and the
    set its graphs join. The allocator releases a pool when its last graph
    dies and refuses its handle after that, so a new pool is made when
    none of the old one's graphs lives."""
    pool = _POOLS.get(device)
    if pool is None or not pool[1]:
        pool = _POOLS[device] = (torch.cuda.graph_pool_handle(), weakref.WeakSet())
    return pool


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of ``device`` that captures run on (a capture may
    not run on the default stream)."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    return stream


# The most steps one graph holds. A capture costs the solve about half a
# millisecond a step (B10's fixed step at hard.cnf B=4096 on an H100, more
# adaptive), paid once a runner; a chunk of the CLI's 256 steps runs a
# 64-step graph four times and captures a quarter of its steps.
MAX_GRAPH_STEPS = 64


class Captured(NamedTuple):
    """One chunk's capture: the state buffers it runs in place on, its
    parts ``((graph, times), ...)`` (a graph of at most
    :data:`MAX_GRAPH_STEPS` steps run ``times`` times, then one of the
    rest), and the formula tensors whose addresses the graphs hold."""

    buffers: tuple
    parts: tuple
    dev: tuple


class ScanChunk(KernelChunk):
    """``chunk_steps`` calls of ``step`` (built for ``device``) as one
    runner: CUDA graphs on a state on ``device``, the plain loop on a CPU
    one. Call it as ``chunk(state, dev)``. ``graphs`` holds the captures by
    batch shape, dtype and formula tensors. A chunk longer than
    :data:`MAX_GRAPH_STEPS` (the CLI's default is 256 steps, and the host
    loop grows its chunks up to 32768) runs a graph of that many steps over
    and over, so that a capture stays short."""

    def __init__(self, step: Callable, chunk_steps: int, device):
        super().__init__(fn=self._run, body=self._body, chunk_steps=chunk_steps,
                         counter=(sys.modules[__name__], "launches"), buffers=self._buffers)
        self.step = step
        self.device = cuda_device(device)
        self.graphs: dict = {}
        self.b10_per_chunk = 0  # B10 launches a chunk makes (pallas)

    def plain(self, state, dev):
        """The plain version: the steps one by one, on any device."""
        for _ in range(self.chunk_steps):
            state = self.step(state, dev)
        return state

    def _run(self, state, dev):
        kind = state.v.device.type
        if kind == "cpu" or state.v.shape[0] == 0:
            return self.plain(state, dev)
        if state.v.device != self.device:
            raise ValueError(f"the scan chunk's step was built for {self.device}; the state is "
                             f"on {state.v.device}")
        cap = self.captured(state, dev)
        for dst, src in zip(cap.buffers, state):
            dst.copy_(src)
        for graph, times in cap.parts:
            for _ in range(times):
                graph.replay()
        self.count(1)
        return type(state)(*(t.clone() for t in cap.buffers))

    def count(self, n: int) -> None:
        """Add ``n`` chunks run by graphs: to :data:`launches`, and their
        B10 launches to B10's count."""
        global launches
        launches += n
        rhs_kernel.launches += n * self.b10_per_chunk

    def captured(self, state, dev) -> Captured:
        """The capture for ``state``'s shapes and dtype and ``dev``'s
        tensors, made at its first use."""
        key = (tuple(t.shape for t in state), state.v.dtype, state.v.device,
               tuple(t.data_ptr() for t in dev))
        cap = self.graphs.get(key)
        if cap is None:
            cap = self.graphs[key] = self._capture(state, dev)
        return cap

    def _capture(self, state, dev) -> Captured:
        global capture_seconds
        device = state.v.device
        buffers = type(state)(*(torch.empty_like(t, memory_format=torch.contiguous_format)
                                for t in state))
        unit = min(self.chunk_steps, MAX_GRAPH_STEPS)
        times, rest = divmod(self.chunk_steps, unit)
        before = rhs_kernel.launches
        t0 = time.perf_counter()
        parts, b10 = [], 0
        try:
            for steps, n in ((unit, times), (rest, 1)):
                if steps:
                    counted = rhs_kernel.launches
                    parts.append((self._graph(buffers, dev, steps), n))
                    b10 += n * (rhs_kernel.launches - counted)
        finally:
            rhs_kernel.launches = before  # the capture launched nothing
        t1 = time.perf_counter()
        for graph, _ in parts:
            graph.instantiate()
        t2 = time.perf_counter()
        self.b10_per_chunk = b10
        capture_seconds += t2 - t0
        logger.info("scan chunk: %d steps at B=%d %s on %s captured in %.3f s, "
                    "instantiated in %.3f s", self.chunk_steps, state.v.shape[0],
                    str(state.v.dtype).replace("torch.", ""), device, t1 - t0, t2 - t1)
        return Captured(buffers, tuple(parts), dev)

    def _graph(self, buffers, dev, steps: int) -> torch.cuda.CUDAGraph:
        """``steps`` steps captured in place on ``buffers`` (not yet
        instantiated)."""
        device = buffers.v.device
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # capture_begin on a side stream, not the torch.cuda.graph context:
        # that one synchronizes and empties the allocator's cache first,
        # which costs a solve tenths of a second for nothing the capture needs
        with torch.cuda.device(device), torch.cuda.stream(capture_stream(device)):
            pool, members = graph_pool(device)
            graph.capture_begin(pool=pool, capture_error_mode="relaxed")
            try:
                self._steps_into(buffers, dev, steps)
            except BaseException:
                # a step the capture cannot take (a read to the host) ends the
                # capture invalid, and ending it raises again: the step's error
                # is the one to report
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
            members.add(graph)
        return graph

    def _steps_into(self, buffers, dev, steps: int) -> None:
        # the steps' result back into the buffers; their last temporaries
        # die with this frame, back to the pool for the next capture
        out = buffers
        for _ in range(steps):
            out = self.step(out, dev)
        for dst, src in zip(buffers, out):
            dst.copy_(src)

    def _buffers(self, state, dev):
        return self.captured(state, dev).buffers

    def _body(self, buffers, stream, stop, stop_all, seeds, seed_index):
        """The device loop's body on its capture ``stream``: the graphs that
        run in place on ``buffers`` as child graph nodes, then the stop
        kernel writing ``done``'s any (``stop_all``: not all) into the word
        at ``stop``."""
        cap = next(c for c in self.graphs.values() if c.buffers is buffers)
        lib, _ = device_loop.load_library()
        for graph, times in cap.parts:
            for _ in range(times):
                bad = ctypes.c_int(-1)
                rc = lib.device_loop_add_graph(stream, graph.raw_cuda_graph(), ctypes.byref(bad))
                if rc != 0 and bad.value >= 0:
                    raise RuntimeError(
                        f"device loop: the captured chunk holds a graph node of type "
                        f"{bad.value} (cudaGraphNodeType), which a conditional body cannot "
                        f"take: {lib.device_loop_error_string(rc).decode()}")
                device_loop.check(lib, rc, "adding the captured chunk")
        device_loop.check(lib, lib.device_loop_stop(stream, stop, buffers.done.data_ptr(),
                                                    buffers.v.shape[0], int(stop_all)),
                          "the stop kernel")
        return cap


def make_scan_chunk(step: Callable, chunk_steps: int, device) -> ScanChunk:
    """``chunk_steps`` steps of ``step(state, dev) -> state`` as one runner
    (:class:`ScanChunk`): captured as a CUDA graph on a CUDA state, the
    plain loop on a CPU one."""
    return ScanChunk(step, chunk_steps, device)
