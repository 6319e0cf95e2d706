"""The on-device multi-chunk loop: up to ``bound`` chunks of a chunk kernel
(B1, B2, B3 or B4) or of the scan tier's captured chunk
(``ops/scan_chunk.py``) in one host launch of a CUDA graph that stops on the
card, on one device or on every rank of a trajectory-only mesh, and its
plain version.

Replaces the ``lax.while_loop`` of ``odesat_tpu/models/ode.py:443-538``
(``make_multi_chunk_runner``) and ``odesat_tpu/models/stoch.py:267-309``
(``make_multi_stoch_runner``), which ``odesat_tpu/utils/tts.py:180-232``
runs as its one dispatch, and on a trajectory-only mesh the one of
``odesat_tpu/parallel/sharded.py:332-414`` and ``:862-922``
(``make_sharded_multi_runner`` and its stoch twin): before each chunk the
loop tests whether any row (every row, with ``stop_all``) is done, over the
whole ``traj`` group on a mesh, and stops if so, and ``steps_advanced`` is
the chunks run times the chunk's steps.

Design for the card (``csrc/device_loop.cu``): one graph a runner,
batch size and stop rule, built at its first dispatch. A head kernel
tests the entry state's done flags and arms a conditional WHILE node; the
node's body is the chunk kernel's own launch, captured once, in place on
the loop's state buffers, with its stop hook pointed at the loop's stop
word (``csrc/ode_lanes.cuh`` State, ``csrc/stoch_chunk.cu`` Hook); a
one-thread decide kernel then counts the chunk and re-arms the node. The
host writes the bound before a launch and reads the count after it: one
word a dispatch, where the host loop read the done flags after every
chunk. The kernels run in place (each CTA reads its rows before its first
barrier and writes them after its last), so a chunk needs no copy.

The state is donated, as JAX donates it (``jax.jit(...,
donate_argnums=0)`` on every multi-chunk runner and, by default, on every
chunk runner: ``odesat_tpu/models/ode.py:350-423``, ``:481``, ``:538``; on
the clause mesh's runners ``odesat_tpu/parallel/sharded.py:164, 216, 562,
581, 613, 624``). The contract, for every runner whose chunk is a
:class:`KernelChunk` (B1-B4 host-paced or in this loop, the scan chunk, the
stoch twin's scan chunk, the trajectory mesh's dispatches) and for the
clause mesh's chunk runners (B6's ``ops/shard_chunk.make_shard_chunk``,
B5's ``ops/shard_stream.make_clause_chunk``, B9's
``ops/stoch_chunk.make_stoch_shard_chunk`` and B8's route of
``parallel/sharded.make_clause_stoch_runner``, which take no ``donate``
switch, as JAX's mesh runners have none):

* A call consumes its input, as JAX's donated argument: a chunk runner's
  call or a dispatch may return a state that shares memory with its input,
  and the input's values are then gone. A caller that needs the entry
  state afterwards copies it first (``models/loop.copy_state``), where JAX does
  (``odesat_tpu/utils/tts.py:197, 206, 224``); a runner built with
  ``donate=False`` (JAX's ``donate=False``) leaves its input as it was.
* Results stay the caller's: a result the caller still holds is never
  changed by a later call of the same runner from another state.
* The plain versions on the CPU may stay out of place (donation allows
  reuse, it does not require it); callers must not depend on either.

The clause mesh's runners tile the rows in the caller's own storage and
untile the result into it (``ops/tiles.py``; a ragged batch, or a field
that cannot be tiled where it lies, through tiles held for its shape), on
the card and on the CPU alike, so the result's tensors are the input's; a
result held is not touched by a call from another state, which runs on
that state's storage. Their scratch (B6's ``ChunkScratch`` and staging, B5's
``ShardScratch``, B8's and B9's ``acc`` and weights, B8's uniforms and
flips) is held for each batch shape, one set a formula that its runners of
every chunk length share (``ops/tiles.held_pool``), and never holds the
caller's storage between calls: a second call of a shape, by any runner of
the formula, allocates nothing on the card.

B1 and B2 have no buffers of their own: the graph's kernel reads the
state's buffer addresses from a pointer block on the card
(``csrc/ode_lanes.cuh`` State), which a dispatch writes beside the bound in
the same copy, and the head kernel reads the done flags through it. A
dispatch runs in place on the caller's own tensors and returns them: no
copy in, none out, and a held result is not touched by a dispatch from
another state, because that one runs on the other state's tensors. Read
through such a block, B3 and B4 compiled 2-3% slower a launch (their
registers and schedule changed; PERF.md), so their graphs, like the scan
chunk's below, run on buffer sets of the runner's (:class:`BufferSets`).

The scan tier's chunk is many kernels, captured by torch into a graph that
runs in place on buffers whose addresses it holds itself
(``ops/scan_chunk.py``). ``KernelChunk.buffers`` hands the loop the
:class:`StateBuffers` a dispatch runs on, for B3, B4 and the scan chunk: a
dispatch from the state it returned last runs in place on it, with no
copy; one from another state copies it into buffers that no result still
referenced holds, a new set (for the scan chunk, a new capture) only when
every set of the shape holds one (:func:`pick`). The scan chunk's body is
that graph as a child graph
node, which a conditional body may hold as long as it holds only kernel,
memset, device-to-device copy, empty, child-graph and conditional nodes
(checked: the loop's build raises otherwise), then a stop kernel that
reduces ``done`` into the stop word by the head kernel's any/all rule.

The stoch kernels draw one 31-bit seed a launch. A captured body cannot
take a new scalar each chunk, so B3 and B4 read theirs on the card from
the loop's seed table at the loop's chunk count: the dispatch draws
``bound`` seeds from the runner's generator, one at a time in the host
loop's order, and copies them to the card before the launch. The chunks
that run use the host loop's seeds, flip for flip. A dispatch that runs
every chunk leaves the generator where the host loop leaves it; one that
stops early has drawn seeds it did not use, and it ends the search.

On a trajectory-only mesh (T > 1 ranks, one process each, S = 1) every
rank runs its own graph over its rows, B1-B4 only (JAX's eligibility:
``parallel/sharded.mesh_loop_route``), and the stop is the group's: the
head and decide kernels exchange one word a rank through pages shared once
over CUDA IPC (:class:`MeshPeers`; ``csrc/device_loop.cu`` states the
protocol and why a ring of two words a rank suffices), so every rank takes
the same decision before every chunk, runs the same chunks and returns the
same ``steps_advanced``, as JAX's ``pmax``/``pmin`` over ``traj`` makes
them. Each rank keeps its count of exchanges on its own page, shared by
every graph of the group. An exchange that waits past the peers' timeout
(the run's collective timeout, ``--dist-timeout``) stops the graph with an
error word that the dispatch's one read brings back: it raises, naming the
ranks that did not arrive. A graph is keyed by the pages too.

What bounds it: nothing of the card's rates (the head reads B done bytes
a dispatch, the decide kernel three words a chunk, and on a mesh T words an
exchange); what it removes is the host between chunks.

The plain version is ``models/loop.run_chunks``, the host loop of the same
rule (with ``parallel/dist.MeshSync`` on a mesh, the stop all-reduced over
gloo), over the kernels' plain versions on the CPU. There is no fallback on
the card: a graph that cannot be built raises with the CUDA error.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from odesat_tpu_torch.ops import _cuda
from odesat_tpu_torch.utils.logging import span

# Graph launches (dispatches) made through :func:`run` in this process, and
# of them those of a trajectory mesh's graphs (exchanging the stop between
# ranks); and the calls that copied a state into a graph's buffers
# (:meth:`StateBuffers.load`: the scan chunk's, from a state it did not
# return last). Plain integers that callers may reset; the chunk kernels'
# own counts grow by the chunks each dispatch ran. ``captures`` counts the
# graphs :class:`DeviceLoop` instantiated, ``releases`` those it destroyed.
launches = 0
mesh_launches = 0
loads = 0
captures = 0
releases = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
# bound, ran, stop, error, the missed ranks' bits (two words)
# (csrc/device_loop.cu), as three 64-bit words of the control block, which
# then holds the pointer block: the state's buffers' addresses, in field order
CTRL_WORDS = 6
BLOCK_AT = CTRL_WORDS // 2
PAGE_BYTES = 256  # a rank's exchange page: its count, then a ring of two words
MAX_PEERS = 64


class StateBuffers:
    """A state's worth of buffers that a captured graph reads and writes in
    place (the scan chunk's), and the held-result rule over them, on
    tensors of any device.

    A call returns :meth:`lend`: views of the buffers, so its result shares
    their memory. The buffers are :meth:`free` while no tensor but their
    own refers to their memory, read from the allocator's count of each
    storage's users, which every view raises, and every view taken from a
    view (torch's CUDA graph trees test their outputs' liveness the same
    way). A runner runs a call from the state these buffers hold
    (:meth:`holds`, the result it returned last) in place on them, with no
    copy; a call from another state takes free buffers and copies the
    state in (:meth:`load`), so a result the caller still holds is never
    written."""

    def __init__(self, state):
        self.tensors = type(state)(*(torch.empty_like(t, memory_format=torch.contiguous_format)
                                     for t in state))
        self._refs = tuple(StorageWeakRef(t.untyped_storage()) for t in self.tensors)
        self._idle = self._users()

    def _users(self) -> tuple:
        return tuple(torch._C._storage_Use_Count(r.cdata) for r in self._refs)

    def holds(self, state) -> bool:
        """Whether ``state`` is these buffers (a result lent from them)."""
        return all(a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.dtype == b.dtype
                   and a.stride() == b.stride() for a, b in zip(state, self.tensors))

    def free(self) -> bool:
        """Whether no result lent from these buffers is still referenced."""
        return self._users() == self._idle

    def load(self, state) -> None:
        """Copy ``state`` into the buffers, unless it is them."""
        global loads
        if not self.holds(state):
            for dst, src in zip(self.tensors, state):
                dst.copy_(src)
            loads += 1

    def lend(self):
        """The buffers as a result: a view of each."""
        return type(self.tensors)(*(t.view_as(t) for t in self.tensors))


def pick(sets, state, in_place: bool = True):
    """The index of the :class:`StateBuffers` of ``sets`` that a call from
    ``state`` runs on: the one that holds ``state`` (``in_place``), else a
    free one; None when every one holds a result still referenced."""
    if in_place:
        for i, b in enumerate(sets):
            if b.holds(state):
                return i
    for i, b in enumerate(sets):
        if b.free():
            return i
    return None


class BufferSets:
    """A kernel runner's buffer sets by state shape (B3's and B4's): called
    as ``KernelChunk.buffers(state, dev)``, the set :func:`pick` takes for a
    dispatch from ``state``, or a new one."""

    def __init__(self):
        self.sets: dict = {}

    def __call__(self, state, dev=None) -> StateBuffers:
        sets = self.sets.setdefault(tuple((t.shape, t.dtype, t.device) for t in state), [])
        i = pick(sets, state)
        if i is None:
            sets.append(StateBuffers(state))
        return sets[-1 if i is None else i]


@dataclasses.dataclass(eq=False)
class KernelChunk:
    """A chunk kernel's runner (B1, B2, B3 or B4), the one form the
    multi-chunk runners and ``solve_exact`` take to the device loop.

    Calling it runs ``fn``: one chunk, through the kernel on a CUDA state
    and its plain version on a CPU one; with ``donate`` (the default) the
    kernel runs in place on its input and returns it, else it writes new
    tensors. ``body(state, stream, stop, stop_all, seeds, seed_index, at)``
    launches the kernel once while the loop captures ``stream``, in place on
    the buffers whose addresses the pointer block at the device address
    ``at`` holds (0: on ``state``, the scan chunk's buffers), and returns
    what the graph must keep alive. ``chunk_steps`` is a chunk's length,
    ``counter`` the ``(module, attribute)`` of the kernel's launch count,
    ``spec`` its tables, and ``generator`` (B3's and B4's runners) the CPU
    generator their seeds come from. ``buffers(state, dev)``, where given,
    returns the :class:`StateBuffers` the body runs in place on for a
    dispatch from ``state`` (B3's, B4's and the scan chunk's); else the
    graph runs on the caller's state through the pointer block (B1's and
    B2's). ``loops`` holds the graphs built for it."""

    fn: Callable
    body: Callable
    chunk_steps: int
    counter: tuple
    spec: object = None
    generator: torch.Generator | None = None
    buffers: Callable | None = None
    donate: bool = True
    loops: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    def __call__(self, *args):
        return self.fn(*args)

    def count(self, n: int) -> None:
        """Add ``n`` launches of the kernel made inside a graph, which runs
        them without the wrapper that counts the others."""
        module, attr = self.counter
        setattr(module, attr, getattr(module, attr) + n)


def _declare(lib) -> None:
    lib.device_loop_create.argtypes = [ctypes.POINTER(_P), _P, _P, _P, _I, _I, _P, _I, _I,
                                       ctypes.c_ulonglong]
    lib.device_loop_create.restype = _I
    lib.device_loop_begin_body.argtypes = [_P, ctypes.POINTER(_P)]
    lib.device_loop_begin_body.restype = _I
    lib.device_loop_end_body.argtypes = [_P]
    lib.device_loop_end_body.restype = _I
    lib.device_loop_launch.argtypes = [_P, _P]
    lib.device_loop_launch.restype = _I
    lib.device_loop_destroy.argtypes = [_P]
    lib.device_loop_destroy.restype = None
    lib.device_loop_add_graph.argtypes = [_P, _P, ctypes.POINTER(_I)]
    lib.device_loop_add_graph.restype = _I
    lib.device_loop_stop.argtypes = [_P, _P, _P, _I, _I]
    lib.device_loop_stop.restype = _I
    lib.device_loop_error_string.argtypes = [_I]
    lib.device_loop_error_string.restype = ctypes.c_char_p


def load_library():
    """Build (at first use) and load the loop's kernels. Returns ``(lib,
    build)``."""
    return _cuda.load("device_loop", _declare)


def check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"device loop: {what} failed: "
                           + lib.device_loop_error_string(rc).decode())


class MeshPeers:
    """The stop exchange of a trajectory group on this rank's card: a page
    a rank (:data:`PAGE_BYTES`, zeroed), shared once over the group through
    ``ops/butterfly.share_pages`` (every rank on this host), and the wait's
    timeout. Built by :func:`mesh_peers`; closed behind barriers by
    ``butterfly.close_all`` (the worker's exit)."""

    def __init__(self, group, device, timeout_s: float):
        import torch.distributed as dist

        from odesat_tpu_torch.ops import butterfly as bf

        self.group = group
        self.device = torch.device(device)
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if not 2 <= self.size <= MAX_PEERS:
            raise ValueError(f"the device loop exchanges its stop over 2 to {MAX_PEERS} "
                             f"ranks, not {self.size}")
        self.timeout_s = float(timeout_s)
        self.index = (self.device.index if self.device.index is not None
                      else torch.cuda.current_device())
        self.lib, _ = bf.load_library()
        self.bases = bf.share_pages(self.lib, group, self.index, PAGE_BYTES,
                                    "the device loop's stop exchange",
                                    "a trajectory group that spans hosts runs the host loop")
        self.table = (_P * self.size)(*self.bases)

    def missing(self, lo: int, hi: int) -> list:
        """The group's ranks (and their global ranks) in an exchange's bits
        of missed ranks."""
        import torch.distributed as dist

        bits = (lo & 0xFFFFFFFF) | ((hi & 0xFFFFFFFF) << 32)
        return [(q, dist.get_global_rank(self.group, q)) for q in range(self.size)
                if bits >> q & 1]

    def close(self) -> None:
        """Unmap and free the pages (a collective over the group)."""
        from odesat_tpu_torch.ops import butterfly as bf

        if self.bases:
            bases, self.bases = self.bases, []
            bf.unshare_pages(self.lib, self.group, self.device, bases)
        bf._COMMS.pop(("device_loop", self.group), None)


def mesh_peers(group, device, timeout_s: float) -> MeshPeers:
    """This process's :class:`MeshPeers` for the trajectory ``group`` (built
    at its first use, a collective)."""
    from odesat_tpu_torch.ops import butterfly as bf

    key = ("device_loop", group)
    peers = bf._COMMS.get(key)
    if peers is None:
        peers = bf._COMMS[key] = MeshPeers(group, device, timeout_s)
    elif peers.device != torch.device(device):
        raise ValueError(f"the trajectory group's exchange pages are on {peers.device}, "
                         f"not {device}")
    return peers


class DeviceLoop:
    """One graph: the :class:`KernelChunk` ``chunk`` over a state of
    ``state``'s shapes, stopping on any (``stop_all``: every) row done,
    with room for ``capacity`` seeds when ``seeded`` (B3, B4). ``buffers``
    (a :class:`StateBuffers`): the buffers the chunk's graph runs in place
    on (the scan chunk's); else the graph runs on the buffers each dispatch
    names in the pointer block. ``peers`` (a :class:`MeshPeers`): the stop
    is the trajectory group's."""

    def __init__(self, chunk, state, stop_all: bool, seeded: bool, capacity: int,
                 buffers=None, peers=None):
        global captures
        self.lib, _ = load_library()
        self.handle = None
        self.device = device = state.v.device
        self.buffers = buffers
        self.like = tuple((t.shape, t.dtype) for t in state)
        # the control words, then the pointer block; written by one copy a
        # dispatch from the pinned host copy (its NumPy view: no torch call)
        words = BLOCK_AT + len(state)
        self.block = torch.zeros(words, dtype=torch.int64, device=device)
        self.ctrl = self.block[:BLOCK_AT].view(torch.int32)
        self.host = torch.zeros(words, dtype=torch.int64).pin_memory()
        self.words = self.host.numpy()
        self.seeds = (torch.zeros(capacity, dtype=torch.int32, device=device) if seeded else
                      None)
        self.host_seeds = torch.zeros(capacity, dtype=torch.int32).pin_memory() if seeded else None
        self.capacity = capacity
        self.peers = peers
        ctrl = self.block.data_ptr()
        at = 0 if buffers is not None else ctrl + 8 * BLOCK_AT
        done = buffers.tensors.done.data_ptr() if buffers is not None else 0
        done_at = at + 8 * state._fields.index("done") if at else 0
        handle = _P()
        mesh = ((peers.table, peers.size, peers.rank, int(peers.timeout_s * 1e9))
                if peers is not None else (None, 0, 0, 0))
        with torch.cuda.device(device):
            check(self.lib, self.lib.device_loop_create(
                ctypes.byref(handle), ctrl, done, done_at, state.v.shape[0], int(stop_all),
                *mesh), "graph creation")
            self.handle = handle
            stream = _P()
            check(self.lib, self.lib.device_loop_begin_body(handle, ctypes.byref(stream)),
                  "body capture")
            try:
                self.keep = chunk.body(
                    buffers.tensors if buffers is not None else state, stream.value, ctrl + 8,
                    stop_all, self.seeds.data_ptr() if seeded else 0, ctrl + 4 if seeded else 0,
                    at)
            except BaseException:
                self.lib.device_loop_end_body(handle)  # ends the capture; the launch's error stands
                raise
            check(self.lib, self.lib.device_loop_end_body(handle), "graph instantiation")
        captures += 1

    def __call__(self, state, bound: int, seeds=None):
        """One dispatch from ``state``, which it consumes; returns ``(state,
        chunks_run)``: on the pointer block, ``state`` itself, run in place;
        on the chunk's buffers, a view of them, ``state`` copied in first
        unless it is them."""
        global launches, mesh_launches
        for name, (shape, dtype), t in zip(state._fields, self.like, state):
            if t.shape != shape or t.dtype != dtype or t.device != self.device:
                raise ValueError(f"state.{name} is {tuple(t.shape)} {t.dtype} on {t.device}; "
                                 f"this loop's graph holds {tuple(shape)} {dtype} on "
                                 f"{self.device}")
            if self.buffers is None and not t.is_contiguous():
                raise ValueError(f"state.{name} is not contiguous: the loop runs in place on it")
        words = self.words
        words[0] = bound
        if self.buffers is not None:
            self.buffers.load(state)
        else:
            words[BLOCK_AT:] = [t.data_ptr() for t in state]
        with torch.cuda.device(self.device):
            self.block.copy_(self.host, non_blocking=True)
            if bound and self.seeds is not None:
                self.host_seeds[:bound] = torch.as_tensor(seeds, dtype=torch.int32)
                self.seeds[:bound].copy_(self.host_seeds[:bound], non_blocking=True)
            check(self.lib, self.lib.device_loop_launch(
                self.handle, torch.cuda.current_stream(self.device).cuda_stream), "graph launch")
        launches += 1
        if self.peers is not None:
            mesh_launches += 1
        # the dispatch's one read: waits for the graph
        ran, _, error, lo, hi = self.ctrl[1:].tolist()
        if error:
            raise RuntimeError(
                f"device loop: the trajectory group's stop exchange waited "
                f"{self.peers.timeout_s} s for (group rank, global rank) "
                f"{self.peers.missing(lo, hi)}, which did not arrive")
        return (self.buffers.lend() if self.buffers is not None else state), ran

    def __del__(self):
        global releases
        if getattr(self, "handle", None) is not None:
            self.lib.device_loop_destroy(self.handle)
            self.handle = None
            releases += 1


def run(chunk: KernelChunk, state, bound: int, stop_all: bool = False, seeds=None, dev=None,
        peers=None):
    """Up to ``bound`` launches of the kernel runner ``chunk`` (B1 or B2;
    B3 or B4 with one seed a chunk in ``seeds``, ``bound`` of them; the scan
    chunk over the formula tensors ``dev``) from the CUDA ``state``, in one
    graph launch; returns ``(state, steps_advanced)``. The dispatch
    consumes ``state`` (the module's contract): the result shares its
    memory or, on the scan chunk's buffers, has been copied from it. With
    ``peers`` (a :class:`MeshPeers`) the stop is the trajectory group's,
    exchanged on the card before every chunk: every rank of the group
    dispatches with the same bound, in the same order. The graph is built
    at the runner's first dispatch at this batch size, stop rule and device
    (the scan chunk's: and the buffers it runs on; a mesh's: and its pages),
    and reused for every bound and, through the pointer block, every
    state."""
    if not isinstance(chunk, KernelChunk):
        raise TypeError(f"the device loop runs a KernelChunk, not {type(chunk).__name__}")
    if bound < 0:
        raise ValueError(f"a dispatch runs at most {bound} chunks: the bound must be >= 0")
    if state.v.device.type != "cuda":
        raise ValueError(f"the device loop runs on CUDA states, not {state.v.device}")
    seeded = seeds is not None
    if seeded and len(seeds) != bound:
        raise ValueError(f"{len(seeds)} seeds for a bound of {bound} chunks")
    B = state.v.shape[0]
    if B == 0:  # no row: any() never holds and all() always does
        if peers is not None:
            raise ValueError("a trajectory rank of the device loop holds at least one row")
        return state, (0 if stop_all else bound) * chunk.chunk_steps
    buffers = chunk.buffers(state, dev) if chunk.buffers is not None else None
    key = (B, bool(stop_all), state.v.device, id(buffers), peers)
    loop = chunk.loops.get(key)
    if loop is None or (seeded and loop.capacity < bound):
        chunk.loops.pop(key, None)
        with span("device_loop.capture"):
            loop = chunk.loops[key] = DeviceLoop(chunk, state, stop_all, seeded,
                                                 max(bound, 1) if seeded else 0, buffers, peers)
    with span("device_loop.dispatch"):
        out, ran = loop(state, bound, seeds)
    chunk.count(ran)
    return out, ran * chunk.chunk_steps
