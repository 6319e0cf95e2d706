"""The scan tier's chunk on the card: ``chunk_steps`` single steps of a step
function (``models/ode.make_step_fn``: the twin's ``gather`` or
``segment_sum`` RHS, or B10 with the torch update; or the stoch twin's
``models/stoch.make_stoch_step`` with its uniform draw,
:class:`StochScanChunk`), captured once as a CUDA graph, and its plain
version, the loop of steps.

Replaces the jitted ``lax.scan`` chunk of ``odesat_tpu/models/ode.py:414-423``
(``make_chunk_runner``'s scan path), which JAX compiles into one program and
runs inside the ``lax.while_loop`` of ``:505-538``, and the stoch twin's of
``odesat_tpu/models/stoch.py:227-235``, which JAX runs host-paced between
chunks (``:276-284``). Eager PyTorch launches each of a step's kernels from
Python (about 15 small ones around each RHS pass, about 20 and a
``torch.rand`` a stoch step), so a host-paced step leaves the card idle
most of the time; the graph launches them all from the card.

Design: at its first call for a batch shape, dtype and formula tensors, a
runner captures the step with ``torch.cuda.CUDAGraph``: a graph of up to
:data:`MAX_GRAPH_STEPS` calls, which a longer chunk runs over and over,
and one of the rest. The graphs read the state from fixed buffers and
write it back into them (the buffers are allocated outside the graphs'
pool; the step's temporaries live in the pool and are dead when a replay
ends).

The state is donated (``ops/device_loop.py`` states the contract): a call
returns views of the capture's buffers, and a call from the state it
returned is the replays alone, in place, with nothing copied in or out, as
the JAX chunk runs on its donated buffers (``odesat_tpu/models/ode.py:
416-423``). A call from another state copies it into a capture whose
buffers are free, and captures again only when every capture of the shape
holds a result the caller still references
(``device_loop.StateBuffers``): a held result is never written. That
happens off the normal path (the solvers pass each result back); each such
capture costs a state's buffers, its temporaries sharing the pool below. A
runner built with ``donate=False`` never runs on its input's buffers: it
copies into free ones, so its input stays. Every live graph of
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

The stoch twin draws its uniforms from a device generator of its own
(``torch.rand(..., generator=)``), which the snapshots store. A capture
registers it with each graph (``CUDAGraph.register_generator_state``): the
draws then read the generator's seed and offset from the card, and each
replay writes the generator's current offset there first and advances it
by what the graph draws. So a captured chunk draws exactly what the same
steps launched from Python draw, and leaves the generator where they leave
it. That write is the host's, once a replay, so the stoch chunk cannot be
a WHILE node's body (the node would replay it with one offset): the device
loop refuses it, and its multi-chunk runner stays host-paced, as JAX's is.

The clause mesh's per-step chunks are captured the same way
(:data:`mesh_launches` counts their chunks), as JAX jits each into one
donated ``lax.scan`` (``odesat_tpu/ops/shard_stream.py:340-358``,
``odesat_tpu/parallel/sharded.py:597-624``, ``:721-759``, ``:782-794``):
the twin's clause step (``models/ode.make_step_fn`` with a group, on
``StateBuffers`` like any scan chunk), the stoch clause twin, and B5's and
B8's steps on rows tiled in the caller's own storage (:class:`TiledChunk`:
a capture keyed by the tiles' addresses, so that a call from the state the
last one returned, in the same storage, replays with nothing copied).
Their steps sum over a clause group (and the shared-dt twin over a
trajectory group) through B7's standalone call: each step declares its
calls (``calls(state) -> [(group, shape, dtype), ...]``), the capture
begins those buffers first (a collective the first time a group sees a
size), holds the calls in a ``butterfly.GraphCalls`` and checks that the
graph made just those, and every launch rebases their flag values to the
groups' counts (``ops/butterfly.py`` argues it). A chunk that calls B7
runs host-paced between chunks, never in the device loop (the rebase is
the host's, once a launch). The stoch chunks' seed lives in a word on the
card (``ops/stoch_chunk.Uniforms.word``), which the runner sets once a
chunk and each draw advances, so one graph serves every chunk.

Counts: :data:`launches` grows by one for every chunk a captured graph runs
(a replay, or a chunk of a device-loop dispatch), the clause mesh's in
:data:`mesh_launches`; :data:`captures` by one a capture (a buffer set and
its graphs). A kernel the step launches through a counted wrapper (B10's
``rhs_kernel.launches``, B5's, B8's and B7's, :func:`counters`) counts while
the graph is captured, when nothing runs; the runner takes those counts
back and adds them once for every chunk that runs.

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
# the chunks of device-loop dispatches; the stoch twin's and the clause
# mesh's (direct replays only) apart. Plain integers that callers may reset.
launches = 0
stoch_launches = 0
mesh_launches = 0
captures = 0
# Seconds spent capturing and instantiating graphs in this process (each
# capture also logs its own); a plain number that callers may reset.
capture_seconds = 0.0

# True inside host_paced(): every chunk runs its plain version, the steps
# launched from Python, on the card too (what a captured chunk is held
# against and timed beside). No flag sets it.
HOST_PACED = False

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


@contextlib.contextmanager
def host_paced():
    """Inside, every scan chunk runs its steps from Python (its plain
    version), on the card too: the yardstick of a captured chunk."""
    global HOST_PACED
    before, HOST_PACED = HOST_PACED, True
    try:
        yield
    finally:
        HOST_PACED = before


def counters() -> tuple:
    """The ``(module, attribute)`` launch counts of the kernels a captured
    step may launch through their counted wrappers: B10, B5, B8 and B7's
    standalone call (both forms)."""
    from odesat_tpu_torch.ops import butterfly, shard_stream, stoch_chunk

    return ((rhs_kernel, "launches"), (shard_stream, "launches"),
            (stoch_chunk, "shard_launches"), (butterfly, "launches"),
            (butterfly, "launches_f64"))


def _read(counted) -> list:
    return [getattr(m, a) for m, a in counted]


# The most steps one graph holds. A capture costs the solve about half a
# millisecond a step (B10's fixed step at hard.cnf B=4096 on an H100, more
# adaptive), paid once a runner; a chunk of the CLI's 256 steps runs a
# 64-step graph four times and captures a quarter of its steps.
MAX_GRAPH_STEPS = 64


class Captured(NamedTuple):
    """One chunk's capture: the state buffers it runs in place on (a
    ``device_loop.StateBuffers``; a :class:`TiledChunk`'s tiled state), its
    parts ``((graph, times), ...)`` (a graph of at most
    :data:`MAX_GRAPH_STEPS` steps run ``times`` times, then one of the
    rest), the formula tensors whose addresses the graphs hold, and for
    each part the ``butterfly.GraphCalls`` of a graph that calls B7 (None
    for one that does not; empty: none does)."""

    buffers: object
    parts: tuple
    dev: tuple
    calls: tuple = ()

    def stale(self) -> bool:
        return any(held is not None and held.stale() for held in self.calls)

    def replay(self) -> None:
        """Run the chunk's graphs on the current stream."""
        for (graph, times), held in zip(self.parts, self.calls or (None,) * len(self.parts)):
            for _ in range(times):
                if held is None:
                    graph.replay()
                else:
                    held.launch()


class ScanChunk(KernelChunk):
    """``chunk_steps`` calls of ``step`` (built for ``device``) as one
    runner: CUDA graphs on a state on ``device``, the plain loop on a CPU
    one. Call it as ``chunk(state, dev)``. ``graphs`` holds the captures by
    batch shape, dtype and formula tensors, and their number (0 for the
    first; another is made only for a call from another state while every
    earlier one's buffers hold a result still referenced). A chunk longer than
    :data:`MAX_GRAPH_STEPS` (the CLI's default is 256 steps, and the host
    loop grows its chunks up to 32768) runs a graph of that many steps over
    and over, so that a capture stays short. ``generators``: the device
    generators the step draws from, registered with every graph;
    ``counter``: the name of this module's count its chunks add to;
    ``donate``: a call may run in place on its input (the default);
    ``calls(state)``: the B7 standalone calls one step from ``state``
    makes, ``[(group, shape, dtype), ...]`` in order (a clause mesh's
    steps); ``prepare(state, dev)``: builds ahead, outside the capture,
    what the step would build at its first call (its tables from the
    formula tensors)."""

    def __init__(self, step: Callable, chunk_steps: int, device, generators=(),
                 counter: str = "launches", donate: bool = True, calls=None, prepare=None):
        super().__init__(fn=self._run, body=self._body, chunk_steps=chunk_steps,
                         counter=(sys.modules[__name__], counter), buffers=self._buffers,
                         donate=donate)
        self.step = step
        self.device = cuda_device(device)
        self.generators = tuple(generators)
        self.calls = calls
        self.prepare = prepare
        self.graphs: dict = {}
        self.per_chunk: dict = {}  # (module, attribute) -> launches a chunk adds

    def b7_calls(self, state) -> list:
        """The B7 standalone calls one chunk from ``state`` makes, in order:
        ``(group, shape, dtype)`` over groups of more than one rank."""
        if self.calls is None:
            return []
        import torch.distributed as dist

        return [c for c in self.calls(state) if c[0] is not None
                and dist.get_world_size(c[0]) > 1] * self.chunk_steps

    def plain(self, state, dev):
        """The plain version: the steps one by one, on any device."""
        for _ in range(self.chunk_steps):
            state = self.step(state, dev)
        return state

    def _plain_here(self, state) -> bool:
        """Whether a call from ``state`` runs the plain version: a CPU state,
        an empty batch, or inside :func:`host_paced`. Raises for a state on
        another card than the step's."""
        if state.v.device.type == "cpu" or state.v.shape[0] == 0 or HOST_PACED:
            return True
        if state.v.device != self.device:
            raise ValueError(f"the chunk's step was built for {self.device}; the state is on "
                             f"{state.v.device}")
        return False

    def _run(self, state, dev=()):
        if self._plain_here(state):
            return self.plain(state, dev)
        cap = self.captured(state, dev, self.donate)
        cap.buffers.load(state)
        cap.replay()
        self.count(1)
        return cap.buffers.lend()

    def count(self, n: int) -> None:
        """Add ``n`` chunks run by graphs: to this runner's count, and the
        launches of its counted kernels to theirs."""
        super().count(n)
        for (module, attr), k in self.per_chunk.items():
            setattr(module, attr, getattr(module, attr) + n * k)

    def captured(self, state, dev, in_place: bool = True) -> Captured:
        """The capture that runs a call from ``state`` over ``dev``'s
        tensors: of the captures of ``state``'s shapes and dtype, the one
        whose buffers hold ``state`` (``in_place``), else one whose buffers
        are free, else a new one."""
        key = (tuple(t.shape for t in state), state.v.dtype, state.v.device,
               tuple(t.data_ptr() for t in dev))
        for k in [k for k, cap in self.graphs.items() if k[0] == key and cap.stale()]:
            del self.graphs[k]  # its B7 buffers were remapped: captured anew
        caps = [cap for (k, _), cap in self.graphs.items() if k == key]
        i = device_loop.pick([cap.buffers for cap in caps], state, in_place)
        if i is not None:
            return caps[i]
        n = max((j for k, j in self.graphs if k == key), default=-1) + 1
        cap = self.graphs[key, n] = self._capture(state, dev)
        return cap

    def _capture(self, state, dev) -> Captured:
        """The chunk captured on a new buffer set of ``state``'s shapes."""
        slots = device_loop.StateBuffers(state)
        return self._capture_on(slots, slots.tensors, dev)

    def _capture_on(self, holder, buffers, dev) -> Captured:
        """The chunk captured in place on ``buffers`` (a state of tensors),
        which ``holder`` keeps (the capture's ``buffers``)."""
        global capture_seconds, captures
        from odesat_tpu_torch.ops import butterfly

        device = buffers.v.device
        if self.prepare is not None:
            self.prepare(buffers, dev)
        calls = self.b7_calls(buffers)
        # the groups' buffers for a step's calls, begun before the capture (a
        # collective the first time a group sees a size)
        comms = butterfly.begin_calls(calls[:len(calls) // self.chunk_steps], device)
        if comms:
            # a capture cannot take back what the allocator holds cached, nor
            # can its ranks' peers on a shared card, and a mesh twin's step
            # needs gigabytes of temporaries: give the cache back first
            torch.cuda.empty_cache()
        unit = min(self.chunk_steps, MAX_GRAPH_STEPS)
        times, rest = divmod(self.chunk_steps, unit)
        counted = counters()
        before = _read(counted)
        t0 = time.perf_counter()
        parts, calls_of, per = [], [], [0] * len(counted)
        try:
            for steps, n in ((unit, times), (rest, 1)):
                if steps:
                    at = _read(counted)
                    graph, held = self._graph(buffers, dev, steps, comms)
                    per = [p + n * (b - a) for p, a, b in zip(per, at, _read(counted))]
                    parts.append((graph, n))
                    calls_of.append(held)
        finally:
            for (module, attr), value in zip(counted, before):
                setattr(module, attr, value)  # the capture launched nothing
        made = sum(k for (module, _), k in zip(counted, per) if module is butterfly)
        if made != len(calls):
            raise RuntimeError(f"a captured chunk of {self.chunk_steps} steps made {made} B7 "
                               f"calls; its steps declare {len(calls)}")
        t1 = time.perf_counter()
        for (graph, _), held in zip(parts, calls_of):
            if held is None:
                graph.instantiate()
        t2 = time.perf_counter()
        self.per_chunk = {c: k for c, k in zip(counted, per) if k}
        capture_seconds += t2 - t0
        captures += 1
        logger.info("scan chunk: %d steps at B=%d %s on %s captured in %.3f s, "
                    "instantiated in %.3f s%s", self.chunk_steps, buffers.v.shape[0],
                    str(buffers.v.dtype).replace("torch.", ""), device, t1 - t0, t2 - t1,
                    f", {len(calls)} B7 calls a chunk" if calls else "")
        return Captured(holder, tuple(parts), dev, tuple(calls_of) if comms else ())

    def _graph(self, buffers, dev, steps: int, comms=()) -> tuple:
        """``steps`` steps captured in place on ``buffers``: the graph (not
        yet instantiated, unless it calls B7) and its
        ``butterfly.GraphCalls`` over ``comms`` (None without)."""
        from odesat_tpu_torch.ops import butterfly

        device = buffers.v.device
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        held = butterfly.GraphCalls(comms) if comms else None
        try:
            # capture_begin on a side stream, not the torch.cuda.graph context:
            # that one synchronizes and empties the allocator's cache first,
            # which costs a solve tenths of a second for nothing the capture needs
            with torch.cuda.device(device), torch.cuda.stream(capture_stream(device)):
                for generator in self.generators:
                    graph.register_generator_state(generator)
                pool, members = graph_pool(device)
                graph.capture_begin(pool=pool, capture_error_mode="relaxed")
                try:
                    self._steps_into(buffers, dev, steps)
                    if held is not None:
                        held.end()
                except BaseException:
                    # a step the capture cannot take (a read to the host) ends
                    # the capture invalid, and ending it raises again: the
                    # step's error is the one to report
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
                members.add(graph)
        finally:
            if held is not None:
                held.restore()
        if held is not None:
            held.bind(graph.raw_cuda_graph())
        return graph, held

    def _steps_into(self, buffers, dev, steps: int) -> None:
        # the steps' result back into the buffers; their last temporaries
        # die with this frame, back to the pool for the next capture
        out = buffers
        for _ in range(steps):
            out = self.step(out, dev)
        for dst, src in zip(buffers, out):
            dst.copy_(src)

    def _buffers(self, state, dev):
        self._check_loop()
        return self.captured(state, dev).buffers

    def _check_loop(self) -> None:
        """Raise for a chunk that draws from a device generator or declares
        B7 calls (a clause mesh's, whose stoch chunks also read a seed word
        the host sets): the device loop would replay it without advancing
        the generator, rebasing its B7 calls' flags or setting its seed,
        which only the host does, once a replay."""
        if self.generators:
            raise RuntimeError("the device loop cannot run a chunk that draws from a device "
                               "generator: a replay inside the WHILE node would not advance "
                               "it; run its chunks host-paced (models/loop.run_chunks)")
        if self.calls is not None:
            raise RuntimeError("the device loop cannot run a chunk that declares B7 calls: the "
                               "host rebases their flags (and sets a stoch chunk's seed word) "
                               "before each replay; run its chunks host-paced "
                               "(models/loop.run_chunks)")

    def _body(self, buffers, stream, stop, stop_all, seeds, seed_index, at=0):
        """The device loop's body on its capture ``stream``: the graphs that
        run in place on ``buffers`` as child graph nodes, then the stop
        kernel writing ``done``'s any (``stop_all``: not all) into the word
        at ``stop``. The graphs hold their buffers' addresses: no pointer
        block (``at``). A chunk that draws from a device generator raises."""
        self._check_loop()
        cap = next(c for c in self.graphs.values() if c.buffers.tensors is buffers)
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


class StochScanChunk(ScanChunk):
    """The stoch twin's chunk: ``chunk_steps`` calls of ``step(state, u)``
    (``models/stoch.make_stoch_step``), each after drawing its uniforms u
    (B, ``n_vars_padded``) float32 from ``generator``, a generator on the
    runner's device (``device_generator``, which the snapshots store). Call
    it as ``chunk(state)``. On a CUDA state the draws are captured with the
    steps and the generator is registered with every graph; its chunks
    count in :data:`stoch_launches`."""

    def __init__(self, step: Callable, chunk_steps: int, device, generator: torch.Generator,
                 n_vars_padded: int, donate: bool = True):
        def draw_step(state, dev):
            u = torch.rand((state.v.shape[0], n_vars_padded), generator=generator,
                           device=state.v.device)
            return step(state, u)

        super().__init__(draw_step, chunk_steps, device, generators=(generator,),
                         counter="stoch_launches", donate=donate)
        self.device_generator = generator


class TiledChunk(ScanChunk):
    """A clause chunk on rows tiled in the caller's own storage: B5's
    (``ops/shard_stream.make_clause_chunk``) and B8's
    (``parallel/sharded.make_clause_stoch_runner``). ``tiles`` (an
    ``ops/tiles.Tiles``) tiles a state's fields with ``fills`` at entry and
    untiles them at exit; ``step(ts, dev)`` advances the tiled state one
    step, writing into scratch that the runner holds for the batch shape;
    ``restore()`` gives that scratch back what is its own (B5's second
    copy of the clause memories, which its launches swap with the state's)
    after the steps. Call it as ``chunk(state, dev=None)``: on a CUDA state
    the tiles are the caller's storage (``ops/tiles.py``: in place for a
    batch of whole tiles, else buffers held for the shape), so the capture
    is keyed by their addresses, and a call from the state the last one
    returned replays with nothing copied, as JAX's donated chunk runs; a
    call from a state in other storage captures anew (the steps write no
    new tensor, so a capture takes nothing from the pool, only its time).
    :data:`KEEP` captures are kept, the oldest dropped. The plain version
    tiles, runs the steps from Python and untiles, on any device."""

    KEEP = 4

    def __init__(self, step: Callable, chunk_steps: int, device, tiles, fills: dict,
                 restore: Callable = lambda: None, calls=None):
        super().__init__(step, chunk_steps, device, counter="mesh_launches", calls=calls)
        self.tiles, self.fills, self.restore = tiles, fills, restore

    def _tile(self, state):
        return type(state)(**self.tiles.tile(state._asdict(), self.fills))

    def _untile(self, state, ts):
        return type(state)(**self.tiles.untile(ts._asdict()))

    def plain(self, state, dev=None):
        """The steps from Python on the tiled state, on any device."""
        ts = self._tile(state)
        for _ in range(self.chunk_steps):
            ts = self.step(ts, dev)
        # the newest clause memories may lie in the scratch's second copy:
        # untiled into the caller's storage from there, and the scratch gets
        # its own copy back, never the caller's storage
        out = self._untile(state, ts)
        self.restore()
        return out

    def _run(self, state, dev=None):
        if self._plain_here(state):
            return self.plain(state, dev)
        ts = self._tile(state)
        key = tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in ts)
        cap = self.graphs.pop(key, None)
        if cap is None or cap.stale():
            cap = self._capture_on(ts, ts, dev)
        self.graphs[key] = cap  # the newest last
        while len(self.graphs) > self.KEEP:
            del self.graphs[next(iter(self.graphs))]
        cap.replay()
        self.count(1)
        return self._untile(state, ts)

    def _steps_into(self, buffers, dev, steps: int) -> None:
        super()._steps_into(buffers, dev, steps)
        self.restore()


def make_scan_chunk(step: Callable, chunk_steps: int, device, donate: bool = True) -> ScanChunk:
    """``chunk_steps`` steps of ``step(state, dev) -> state`` as one runner
    (:class:`ScanChunk`): captured as a CUDA graph on a CUDA state, the
    plain loop on a CPU one."""
    return ScanChunk(step, chunk_steps, device, donate=donate)
