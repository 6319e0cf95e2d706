"""The butterfly all-reduce over a clause group (kernel B7): hand-written
CUDA for Hopper over CUDA IPC buffers, fused into the kernels that consume
its sums or as a call of its own, and its plain version.

Replaces the TPU kernel ``odesat_tpu/ops/butterfly.py::butterfly_allreduce``
(:99), which the whole-chunk clause-shard kernels B6 and B9 ran inside
themselves: round r swapped the accumulator with partner ``index ^ 2^r`` over
ICI remote DMA and combined the partner's payload straight into the
kernel's accumulator, so every shard added in the same pairwise order and
ended with the same bits. Here the ranks of a clause group are processes
and B6's and B9's chunks are sequences of launches (``ops/shard_chunk.py``,
``ops/stoch_chunk.py``): every kernel of a launch that reads a reduced
value reads the S ranks' partials of the call it consumes, its own slot
and the peers' IPC-mapped slots, and adds them itself
(``csrc/bfly_tree.cuh``), so no reduced buffer crosses device memory and no
launch of its own runs between them. The sums that torch operations
consume (B5's and B8's, the ``--shard-chunk off`` paths, which JAX psums
outside any kernel) take the standalone call (:func:`butterfly`,
``csrc/butterfly.cu``).

What every version computes (:func:`combine` defines it): each of the S
ranks holds a partial of the same shape and dtype, float32 or float64
(the standalone call's two forms; the fused readers take float32); every
rank gets the same
result, bit for bit: the partials in rank order combined as a pairwise
tree, level by level, ``(a0 + a1)`` at S = 2, ``(a0 + a1) + (a2 + a3)`` at
S = 4, an absent partner skipped at an S that is not a power of two
(``(a0 + a1) + a2`` at S = 3). IEEE addition is commutative, so this is the
order in which the TPU kernel's log2(S) rounds add. ``zones``, ``None`` or
``(period, n_max)``, names a max zone: the last ``n_max`` words of every
``period`` words of the flat buffer combine by max instead of sum (JAX's
``combine`` max-combines the error zone of the adaptive pass), NaN
propagating as in ``torch.maximum`` (the result is the canonical quiet NaN)
and, of two equal values (+0 and -0), the lower rank's kept.

The design on the card (:class:`Communicator`, one a clause group):

* **Buffers shared once.** At a group's first use, and again only when a
  slot must grow, each rank allocates one device buffer in the extension
  (``cudaMalloc``, so an IPC handle names exactly it, whatever torch's
  caching allocator does), holding a page of flags and ``SLOTS`` partial
  slots, and exports it with ``cudaIpcGetMemHandle``; the handles travel
  once over the group (``all_gather_object``) and the peers map them with
  ``cudaIpcOpenMemHandle``. Every rank of the group must run on this host
  (a pod keeps each clause group inside one process's ranks,
  ``parallel/multihost.make_pod_mesh``), and a peer on another card must be
  reachable (``cudaDeviceCanAccessPeer``), else set-up raises. Every mapping is closed
  behind barriers before any rank frees its buffer (:meth:`Communicator.close`,
  called by a growth, by :func:`close_all` and by ``parallel/launch.py``'s
  worker exit). A process cannot open its own handle; at S = 1 there is no
  communicator.
* **One counter a rank, waits in the stream.** The group's launches are
  numbered j = 0, 1, ... on every rank alike (a B6 or B9 launch, a chunk's
  closing launch, a standalone call). Before launch j the rank's stream
  waits (``cuStreamWaitValue32``, GEQ) until every peer's flag is at least
  j; after launch j it raises its own flag to j + 1
  (``cuStreamWriteValue32``, behind a memory fence). That one write means
  both "my partial of call j is written" and "my reads of every earlier
  call are done". A standalone call j, which reads its own call, raises its
  flag to j + 1 once its partial is in its slot and waits for j + 1 before
  its kernel reads the S slots. Without MPS the contexts of ranks that share
  a card are time-sliced, so a kernel spinning on a peer's flag would hold
  the slice the peer needs; a stream wait holds nothing.
* **K slots a mode, one ring for all: launch j writes slot j mod 3.** A
  runner needs K slots, K 1 plus the furthest distance back at which a
  launch reads a call's partial:

  - a fixed B6 step: ``step`` j applies call j - 1's dv and writes call j;
    the chunk's closing ``apply`` reads j - 1: K = 2;
  - adaptive B6: ``first`` j commits the previous step, reading that
    step's dv1 (call j - 2) and its dv2 and error (j - 1); ``half`` j + 1
    reads call j's dv1 and sat count; the closing ``commit`` reads j - 1
    and j - 2: K = 3;
  - B9: launch t flips with call t - 1's sums; the closing flip reads the
    last: K = 2;
  - the standalone call reads its own slot after its raise, and its read is
    done before its next raise, as a read at distance 1 would be: K = 2.
    Its float64 form (the torch twin's clause step in float64,
    ``models/ode.make_step_fn``) is a standalone call like the others: the
    same counter, the same ring, the same raise and wait; only its slot
    holds doubles (the slots are sized in bytes). So the argument below
    covers it unchanged, and so does the model check.

  Within a runner, no rank writes a slot that a peer may still read: launch
  j overwrites call j - K, whose readers are launches j - K .. j - 1; every
  peer has finished launch j - 1 (and all before it, in stream order) once
  its flag is at least j, which launch j waited for. No launch reads a
  partial before it is written: a reader of call c at launch c + d waited
  for flags of at least c + d >= c + 1. A chunk's first launch reads
  nothing (B6 and B9 have no prologue there), so fused reads never cross a
  runner's start. A standalone call's read does: it comes after the call's
  raise, so the launch after it, the next runner's first, may already run
  on a peer. Were each runner to take slot j mod its own K, that launch
  could take the very slot being read (a standalone call j on slot j mod
  2 = 1, an adaptive chunk's first launch j + 1 on (j + 1) mod 3 = 1). So
  every launch takes slot j mod ``SLOTS`` = 3, the largest K: one mapping
  whatever the runner, safe for every K up to 3. The waits therefore hold
  across chunk boundaries, across runners and across ``drive_chunks``'
  early exit, as long as every rank makes the same launches, which the
  runners do: the counter carries on and is never reset but by a growth of
  the slots. ``tests/test_torch_bfly_fused.py`` enumerates every
  interleaving of these schedules at S = 2, 3 and 4: K slots are safe for
  each runner alone and K - 1 are not, and runners of other K on one
  counter are safe on the one ring and not on their own K.

* **Calls inside a CUDA graph.** The clause mesh's per-step chunks (B5's,
  B8's, the twins', ``ops/scan_chunk.py``) are captured as CUDA graphs, as
  JAX jits them, and their standalone calls with them
  (:class:`GraphCalls`). The flag values are the count, which a graph
  would freeze, so ``csrc/butterfly.cu`` ``bfly_graph_launch`` rebases
  every wait and write of the graph before each launch to the count its
  communicator stands at then (``cuGraphExecBatchMemOpNodeSetParams``):
  the waits stay in the stream, where a kernel that polled a flag would
  hold the card's time slice on every step. The slots are not rebased:
  a graph makes a multiple of ``SLOTS`` calls (empty calls, a raise and a
  wait with no slot, fill the rest) and starts at a count that is a
  multiple of ``SLOTS`` (empty calls from the host first, where a launch
  from elsewhere left the count between), so its call k takes slot k mod
  ``SLOTS``, the slot the same call made from the host takes, and the
  ring's argument above holds unchanged: a replay makes exactly the calls
  its steps would make from the host, at the same counts and slots. How
  many calls a graph makes is a function of its chunk alone (its steps'
  calls, declared by each step and checked at capture, padded to a
  multiple of ``SLOTS``), the same on every rank of the group. An empty
  call writes and reads no slot; it raises the flag behind everything
  before it, as any call does. A growth of the slots frees the buffers a
  graph holds: the graph is then stale and captured anew.

A rank's calls must follow its peers' in kind and order (as the runners do
on every rank); a buffer size and dtype a group has not seen yet is agreed
over the group first, and a size or dtype that differs between ranks
raises on every rank.
The wrappers raise and never fall back: :func:`butterfly_cuda` and
:func:`tree_cuda` take CUDA tensors only, :func:`butterfly_plain` (a gloo
gather, :func:`gather_plain`, and the tree on the host) is the CPU path and
the reference, and :func:`butterfly` picks by the tensor's device.
"""

from __future__ import annotations

import ctypes
import math
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from odesat_tpu_torch.ops import _cuda

# Standalone B7 launches (butterfly_cuda, tree_cuda) of the float32 form and
# of the float64 form, and B6 or B9 launches that read S > 1 ranks' slots
# themselves (B7 fused into their prologues), in this process. Plain
# integers that callers may reset; chip_smoke.py reads them.
launches = 0
launches_f64 = 0
fused_launches = 0

MAX_RANKS = 64  # csrc/bfly_tree.cuh kMaxRanks
SLOTS = 3  # partial slots a rank's buffer holds, the ring every launch takes: the largest K
FLAG_BYTES = 256  # the flag page at the head of a rank's buffer
_ALIGN = 256  # bytes: slots start on 256-byte boundaries
_HANDLE = 64  # CUDA_IPC_HANDLE_SIZE
_OUT_OF_MEMORY = 2  # cudaErrorMemoryAllocation
_BUS = 32

# the standalone call's forms: the dtype and its entry points' suffix
FORMS = {torch.float32: "", torch.float64: "_f64"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _declare(lib) -> None:
    lib.bfly_init.argtypes = [_I]
    lib.bfly_check_mem_ops.argtypes = [_I]
    lib.bfly_alloc.argtypes = [ctypes.c_size_t, ctypes.POINTER(_P), ctypes.c_char_p]
    lib.bfly_free.argtypes = [_P]
    lib.bfly_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(_P)]
    lib.bfly_close.argtypes = [_P]
    lib.bfly_bus_id.argtypes = [_I, ctypes.c_char_p, _I]
    lib.bfly_device_of.argtypes = [ctypes.c_char_p, ctypes.POINTER(_I)]
    lib.bfly_can_access_peer.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.bfly_signal.argtypes = [_P, ctypes.c_uint, _P]
    lib.bfly_wait.argtypes = [_P, _I, _I, ctypes.c_uint, _P]
    for suffix in FORMS.values():
        getattr(lib, "bfly_tree" + suffix).argtypes = [_P, _I, _P, _L, _L, _L, _I, _P]
        getattr(lib, "bfly_reduce" + suffix).argtypes = [_P, _P, _I, _I, ctypes.c_uint, _P, _L,
                                                         _L, _L, _I, _P]
    for name in ("bfly_init", "bfly_check_mem_ops", "bfly_alloc", "bfly_free", "bfly_open",
                 "bfly_close", "bfly_bus_id", "bfly_device_of", "bfly_can_access_peer",
                 "bfly_signal", "bfly_wait", "bfly_tree", "bfly_reduce", "bfly_tree_f64",
                 "bfly_reduce_f64"):
        getattr(lib, name).restype = _I
    lib.bfly_error_string.argtypes = [_I]
    lib.bfly_error_string.restype = ctypes.c_char_p
    lib.bfly_init_graphs.argtypes = []
    lib.bfly_graph_create.argtypes = [_P, ctypes.POINTER(_I), ctypes.POINTER(_P)]
    lib.bfly_graph_ops.argtypes = [_P, _P, _P, _P, _I]
    lib.bfly_graph_ops.restype = None
    lib.bfly_graph_bind.argtypes = [_P, _P, _P, _I]
    lib.bfly_graph_launch.argtypes = [_P, _P, _P]
    for name in ("bfly_init_graphs", "bfly_graph_create", "bfly_graph_bind", "bfly_graph_launch"):
        getattr(lib, name).restype = _I
    lib.bfly_graph_destroy.argtypes = [_P]
    lib.bfly_graph_destroy.restype = None


def load_library():
    """Build (at first use) and load ``csrc/butterfly.cu``. Returns ``(lib,
    build)``."""
    return _cuda.load("butterfly", _declare)


def _raise_for(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"B7 {what} failed: {lib.bfly_error_string(rc).decode()}")


def _count(dtype) -> None:
    """Count one standalone launch of ``dtype``'s form."""
    global launches, launches_f64
    if dtype == torch.float64:
        launches_f64 += 1
    else:
        launches += 1


def check_dtype(dtype) -> None:
    """Raise unless the standalone call has a form for ``dtype``."""
    if dtype not in FORMS:
        raise ValueError(f"B7 reduces float32 or float64 buffers, not {dtype}")


def zone_args(zones, numel: int) -> tuple:
    """``(period, n_max)`` of ``zones`` (None: all sum), checked."""
    if zones is None:
        return max(1, numel), 0
    period, n_max = (int(z) for z in zones)
    if period < 1 or not 0 <= n_max <= period:
        raise ValueError(f"zones {zones!r}: a period of at least 1 word whose last n_max "
                         "(0 <= n_max <= period) words max-combine")
    return period, n_max


# ---------------------------------------------------------------- plain


def _max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B7's MAX: NaN if either is NaN, else the larger, ``a`` of two equal
    values."""
    nan = torch.isnan(a) | torch.isnan(b)
    return torch.where(nan, torch.full_like(a, math.nan), torch.where(a < b, b, a))


def tree(parts: list, op) -> torch.Tensor:
    """``parts`` (rank order) combined by ``op`` as B7's pairwise tree:
    level by level, ``parts[i]`` with ``parts[i + w]`` for w = 1, 2, 4, ...,
    the lower block on the left, an absent partner skipped."""
    vals, w = list(parts), 1
    while w < len(vals):
        for i in range(0, len(vals) - w, 2 * w):
            vals[i] = op(vals[i], vals[i + w])
        w *= 2
    return vals[0]


def combine(parts: list, zones=None) -> torch.Tensor:
    """The S flat partials ``parts`` (rank order) combined as B7 combines
    them: the sum tree, and the max tree in the max zone."""
    n = parts[0].numel()
    period, n_max = zone_args(zones, n)
    out = tree(parts, torch.add)
    if n_max:
        in_max = torch.arange(n, device=out.device) % period >= period - n_max
        out = torch.where(in_max, tree(parts, _max), out)
    return out


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _agree(group, shape, dtype) -> None:
    """Raise on every rank unless every rank of ``group`` passes the same
    ``shape`` (a shape or a size) and ``dtype`` (one small collective)."""
    seen = [None] * _group_size(group)
    dist.all_gather_object(seen, (shape, str(dtype)), group=group)
    if any(s != seen[0] for s in seen):
        raise ValueError(f"the ranks of the group pass buffers of shapes and dtypes {seen}; B7 "
                         "takes one shape and one dtype on every rank")


_GATHERED: set = set()  # (group, shape, dtype) the ranks have agreed on


def gather_plain(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` (rank order), gathered over ``group``
    (``dist.all_gather``; through the host for CUDA tensors on gloo), as
    flat CPU tensors of its dtype (float32 or float64): the partials B7
    combines. A collective: every rank of the group calls it together. A
    shape or dtype that differs between ranks raises on every rank."""
    check_dtype(t.dtype)
    flat = t.detach().reshape(-1)
    if _group_size(group) == 1:
        return [flat.cpu().clone()]
    key = (group, tuple(t.shape), t.dtype)
    if key not in _GATHERED:  # agreed once a shape and dtype, as the slots are
        _agree(group, tuple(t.shape), t.dtype)
        _GATHERED.add(key)
    where = t.device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    flat = flat.to(where).contiguous()
    parts = [torch.empty_like(flat) for _ in range(_group_size(group))]
    dist.all_gather(parts, flat, group=group)
    return [p.cpu() for p in parts]


def butterfly_plain(t: torch.Tensor, group, zones=None) -> torch.Tensor:
    """B7 in torch ops: every rank's ``t`` gathered over ``group``
    (:func:`gather_plain`) and combined on the CPU in the butterfly's tree
    order (:func:`combine`); returned on ``t``'s device, a new tensor of its
    shape. A collective: every rank of the group calls it together."""
    zone_args(zones, t.numel())
    return combine(gather_plain(t, group), zones).reshape(t.shape).to(t.device)


def combine_parts(parts: list, zones=None) -> torch.Tensor:
    """The S partials ``parts`` (rank order, tensors of one shape) combined
    as :func:`combine` combines them, in their shape: what a kernel that
    reads the S slots itself computes."""
    return combine([p.reshape(-1) for p in parts], zones).reshape(parts[0].shape)


# ---------------------------------------------------------------- kernel


class _Raw:
    """A device pointer as torch takes one (``__cuda_array_interface__``):
    bytes, not owned."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                         "data": (ptr, False), "version": 2}


class Communicator:
    """B7 for one clause group on this rank's card: the shared buffers, the
    launch counter and the waits. Built by :func:`communicator`."""

    def __init__(self, group, device):
        self.group = group
        self.device = torch.device(device)
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if self.size > MAX_RANKS:
            raise ValueError(f"B7 takes at most {MAX_RANKS} ranks a group, not {self.size}")
        self.lib, _ = load_library()
        index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        self.index = index
        _raise_for(self.lib, self.lib.bfly_init(index), "set-up (the driver entry points)")
        _raise_for(self.lib, self.lib.bfly_check_mem_ops(index),
                   "set-up (stream memory operations)")
        self.sms = torch.cuda.get_device_properties(index).multi_processor_count
        self.cap = 0  # bytes a slot
        self.count = 0  # launches since the buffers were mapped: the flag's value
        self.waited = 0  # the largest flag value this stream has waited for
        self.maps = 0  # the buffers mapped so far: a graph holds the addresses of one map
        self.capturing = False  # a graph is capturing this group's calls
        self.agreed: set = set()  # (bytes, dtype) of the buffers the group has agreed on
        self.bases: list = []  # every rank's buffer in this process (rank order)
        self._views: dict = {}

    # -- set-up and teardown

    def _map(self, nbytes: int) -> None:
        """Allocate, export, exchange and map the buffers for slots of at
        least ``nbytes`` bytes."""
        self._unmap()
        cap = -(-max(nbytes, 1) // _ALIGN) * _ALIGN
        bases = share_pages(self.lib, self.group, self.index, FLAG_BYTES + SLOTS * cap,
                            "B7", "a clause group must lie inside one process of a pod "
                            "(make_pod_mesh)")
        slots = [[base + FLAG_BYTES + i * cap for base in bases] for i in range(SLOTS)]
        # every rank's slot i as a byte tensor of this process (the peers'
        # through their mappings), rank order; parts() views it as a dtype
        self.slot_views = [[torch.as_tensor(_Raw(ptr, cap), device=self.device)
                            for ptr in row] for row in slots]
        self.bases, self.cap, self.count, self.waited = bases, cap, 0, 0
        self.maps += 1
        self.flags = (_P * self.size)(*bases)
        self.own_slots = [row[self.rank] for row in slots]
        self.slot_ptrs = [(_P * self.size)(*row) for row in slots]
        self._views = {}

    def _unmap(self) -> None:
        """Close every mapping behind a barrier, then free this rank's
        buffer: no rank frees memory that a peer still reads or maps."""
        if not self.bases:
            return
        self.slot_views, self._views = None, {}
        bases, self.bases, self.cap = self.bases, [], 0
        unshare_pages(self.lib, self.group, self.device, bases)

    def close(self) -> None:
        """Unmap and free this group's buffers (a collective over the
        group)."""
        self._unmap()
        self.agreed.clear()
        _COMMS.pop(self.group, None)

    # -- the launch schedule

    def begin(self, shape, dtype=torch.float32) -> None:
        """Set up for launches whose partials have ``shape`` and ``dtype``.
        A collective the first time the group sees the size and dtype (the
        ranks agree on them; a growth remaps every rank's buffer)."""
        check_dtype(dtype)
        numel = math.prod(shape)
        nbytes = numel * dtype.itemsize
        if (nbytes, dtype) not in self.agreed:
            if self.capturing:
                raise ValueError(f"a captured chunk calls B7 on a {tuple(shape)} {dtype} buffer "
                                 "that its steps did not declare (b7_calls)")
            _agree(self.group, numel, dtype)
            if nbytes > self.cap:
                self._map(nbytes)
            self.agreed.add((nbytes, dtype))

    def _stream(self):
        return torch.cuda.current_stream(self.device).cuda_stream

    def wait(self) -> None:
        """Hold the current stream until every peer has finished launch
        ``count`` - 1 (its flag at least ``count``): before launch
        ``count`` reads a peer's partial or writes a slot."""
        if self.waited >= self.count:
            return
        with torch.cuda.device(self.index):
            rc = self.lib.bfly_wait(self.flags, self.size, self.rank, self.count & 0xFFFFFFFF,
                                    self._stream())
        _raise_for(self.lib, rc, "wait")
        self.waited = self.count

    def signal(self) -> None:
        """Launch ``count`` is enqueued: raise this rank's flag to ``count``
        + 1 behind it, and count it."""
        with torch.cuda.device(self.index):
            rc = self.lib.bfly_signal(self.bases[self.rank], (self.count + 1) & 0xFFFFFFFF,
                                      self._stream())
        _raise_for(self.lib, rc, "signal")
        self.count += 1

    def pad(self) -> None:
        """An empty call ``count`` on the current stream: the flag raised to
        ``count`` + 1 and the peers awaited there, no slot written or read.
        It takes a number of the ring as a call does (every rank of the
        group makes it at the same count)."""
        self.signal()
        self.wait()

    def align(self) -> None:
        """Empty calls until ``count`` is a multiple of ``SLOTS``: where a
        captured graph starts."""
        while self.count % SLOTS:
            self.pad()

    def parts(self, shape, dtype=torch.float32) -> list:
        """Every rank's slot of the current launch, rank order, as tensors
        of ``shape`` and ``dtype``: what a later launch that consumes it
        reads (this rank's own slot among them)."""
        i, shape = self.count % SLOTS, tuple(shape)
        views = self._views.get((i, shape, dtype))
        if views is None:
            nbytes = math.prod(shape) * dtype.itemsize
            if (nbytes, dtype) not in self.agreed:
                raise ValueError("B7's slots of a size or dtype the group has not begun "
                                 "(begin(shape, dtype))")
            views = self._views[(i, shape, dtype)] = [v[:nbytes].view(dtype).view(shape)
                                                      for v in self.slot_views[i]]
        return views

    def slot(self, shape, dtype=torch.float32) -> torch.Tensor:
        """This rank's slot of the current launch, as a contiguous tensor of
        ``shape`` and ``dtype``: the launch writes its partial there (after
        :meth:`wait`)."""
        return self.parts(shape, dtype)[self.rank]

    def flags_on_card(self) -> list:
        """Every rank's flag as the card holds it now, rank order (a read
        that waits for the current stream): the count of the launches each
        rank has finished."""
        torch.cuda.current_stream(self.device).synchronize()
        return [int(torch.as_tensor(_Raw(base, 4), device=self.device).view(torch.int32)
                    .item()) & 0xFFFFFFFF for base in self.bases]

    # -- the standalone call

    def reduce(self, part: torch.Tensor, zones=None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The standalone call ``count`` on the current stream, once
        ``part``, this rank's slot of the call (:meth:`slot`), holds the
        partial: the flag raised, the peers' awaited, then the kernel over
        the S slots into ``out`` (allocated when None), which is
        returned. ``part``'s dtype picks the form: float32 or float64."""
        i, dtype = self.count % SLOTS, part.dtype
        if (part.data_ptr() != self.own_slots[i]
                or (part.numel() * dtype.itemsize, dtype) not in self.agreed):
            raise ValueError("B7 reduces the communicator's slot of this call "
                             "(slot(shape, dtype))")
        period, n_max = zone_args(zones, part.numel())
        if out is None:
            out = torch.empty(part.shape, dtype=dtype, device=self.device)
        if (out.device != self.device or out.dtype != dtype or not out.is_contiguous()
                or out.shape != part.shape):
            raise ValueError(f"out is {tuple(out.shape)} {out.dtype} on {out.device}; B7 writes "
                             f"a contiguous {tuple(part.shape)} {dtype} on {self.device}")
        if {out.data_ptr()} & set(self.own_slots):
            raise ValueError("B7 writes its result into a buffer of its own, not a slot")
        call = getattr(self.lib, "bfly_reduce" + FORMS[dtype])
        with torch.cuda.device(self.index):
            rc = call(self.slot_ptrs[i], self.flags, self.size, self.rank,
                      self.count & 0xFFFFFFFF, out.data_ptr(), part.numel(), period, n_max,
                      self.sms, self._stream())
        _raise_for(self.lib, rc, "call")
        self.count += 1
        self.waited = self.count
        _count(dtype)
        return out


class GraphCalls:
    """The standalone calls of the communicators ``comms`` that one CUDA
    graph captures (``ops/scan_chunk.py``), and its launch with their flag
    values rebased (the module's docstring argues it). Build it on the
    host just before the capture begins, call :meth:`end` while the
    capture still runs (the empty calls that fill the graph to a multiple
    of ``SLOTS``), :meth:`restore` once it has ended, however it ended,
    and :meth:`bind` with the captured graph; then :meth:`launch` runs
    the graph on the current stream, as often as needed."""

    def __init__(self, comms: Sequence[Communicator]):
        self.comms = tuple(comms)
        self.saved = [(c.count, c.waited) for c in self.comms]
        self.maps = [c.maps for c in self.comms]
        self.start = []
        for c in self.comms:
            # the count a launch starts at, a multiple of SLOTS; the graph's
            # first call waits for the peers whatever came before it
            c.count = -(-c.count // SLOTS) * SLOTS
            c.waited = -1
            c.capturing = True
            self.start.append(c.count)
        self.calls: list = []  # a launch's calls (empty ones included) a communicator
        self.handle = None
        self.lib = self.comms[0].lib if self.comms else None

    def end(self) -> None:
        """Fill the captured calls to a multiple of ``SLOTS`` with empty
        ones (still capturing)."""
        for c, start in zip(self.comms, self.start):
            while (c.count - start) % SLOTS:
                c.pad()
        self.calls = [c.count - start for c, start in zip(self.comms, self.start)]

    def restore(self) -> None:
        """The counts as they were before the capture, which ran nothing."""
        for c, (count, waited) in zip(self.comms, self.saved):
            c.count, c.waited, c.capturing = count, waited, False

    def bind(self, graph: int) -> None:
        """Instantiate ``graph`` (a ``cudaGraph_t``, the capture's), read
        its flag operations in the same pass, and tie each to its
        communicator and its offset from the count the capture started
        at."""
        lib = self.lib
        _raise_for(lib, lib.bfly_init_graphs(), "graph set-up (driver entry points)")
        n, handle = _I(), _P()

        def create():
            return lib.bfly_graph_create(graph, ctypes.byref(n), ctypes.byref(handle))

        rc = create()
        if rc == _OUT_OF_MEMORY:
            # instantiating the graph takes device memory that the
            # allocator may hold cached (a rank sharing the card holds its
            # own cache too): give that back, and try once more
            torch.cuda.empty_cache()
            rc = create()
        _raise_for(lib, rc, "instantiating the captured graph")
        self.handle = handle  # destroyed with this object, whatever raises below
        addrs = (ctypes.c_ulonglong * n.value)()
        values = (ctypes.c_uint * n.value)()
        kinds = (_I * n.value)()
        lib.bfly_graph_ops(handle, addrs, values, kinds, n.value)
        owner = {base: (i, k) for i, c in enumerate(self.comms) for k, base in enumerate(c.bases)}
        comm, offset, writes = [], [], [0] * len(self.comms)
        for addr, value, kind in zip(addrs, values, kinds):
            if addr not in owner:
                raise RuntimeError(f"the captured graph waits or writes at {addr:#x}, no flag of "
                                   "its B7 groups")
            i, k = owner[addr]
            c = self.comms[i]
            off = (value - self.start[i]) & 0xFFFFFFFF
            if off > self.calls[i] or (kind == 2) != (k == c.rank):
                raise RuntimeError(f"the captured graph's flag operation (kind {kind}, value "
                                   f"{value}) is not one of its {self.calls[i]} calls on rank "
                                   f"{c.rank}'s group")
            writes[i] += kind == 2
            comm.append(i)
            offset.append(off)
        if writes != self.calls:
            raise RuntimeError(f"the captured graph holds {writes} flag writes for {self.calls} "
                               "B7 calls: the stream memory operations were not captured as "
                               "graph nodes")
        _raise_for(lib, lib.bfly_graph_bind(handle, (_I * len(comm))(*comm),
                                            (ctypes.c_uint * len(offset))(*offset), len(comm)),
                   "binding the captured graph's flags")

    def stale(self) -> bool:
        """Whether a communicator has remapped or closed the buffers whose
        addresses the graph holds."""
        return any(c.maps != m or not c.bases for c, m in zip(self.comms, self.maps))

    def launch(self) -> None:
        """Run the graph on the current stream: each communicator brought
        to a multiple of ``SLOTS`` (empty calls), the flag values rebased
        to its count, the counts advanced by the graph's calls."""
        if self.stale():
            raise RuntimeError("B7's buffers were remapped since this graph was captured")
        for c in self.comms:
            c.align()
        counts = (ctypes.c_uint * len(self.comms))(*(c.count & 0xFFFFFFFF for c in self.comms))
        device = self.comms[0].device
        with torch.cuda.device(self.comms[0].index):
            rc = self.lib.bfly_graph_launch(self.handle, counts,
                                            torch.cuda.current_stream(device).cuda_stream)
        _raise_for(self.lib, rc, "graph launch")
        for c, n in zip(self.comms, self.calls):
            c.count += n
            c.waited = c.count

    def __del__(self):
        if getattr(self, "handle", None) is not None:
            self.lib.bfly_graph_destroy(self.handle)
            self.handle = None


def begin_calls(calls, device) -> list:
    """The communicators of the standalone calls ``calls`` ((group, shape,
    dtype), in a chunk's order; groups of one rank make none), each begun
    with its calls' buffers (a collective the first time a group sees a
    size), in order of first use: what a chunk's capture holds."""
    comms: list = []
    for group, shape, dtype in calls:
        comm = communicator(group, device)
        comm.begin(shape, dtype)
        if comm not in comms:
            comms.append(comm)
    return comms


def share_pages(lib, group, index: int, nbytes: int, what: str, layout: str) -> list:
    """``nbytes`` of zeroed device memory on card ``index`` for every rank of
    ``group``, shared once through CUDA IPC: each rank allocates its own in
    the extension (``cudaMalloc``, so that a handle names exactly it) and
    exports it, the handles travel over the group (``all_gather_object``),
    and each rank maps its peers'. Returns every rank's base address in
    this process, rank order (its own among them). A collective. Raises,
    freeing what it took, when the ranks run on more than one host (a
    message naming ``what`` and the ``layout`` a run must keep), when a
    peer's card is not visible here or cannot be reached."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    own, handle = _P(), ctypes.create_string_buffer(_HANDLE)
    with torch.cuda.device(index):
        _raise_for(lib, lib.bfly_alloc(nbytes, ctypes.byref(own), handle),
                   "allocation (cudaMalloc, cudaIpcGetMemHandle)")
        bus = ctypes.create_string_buffer(_BUS)
        _raise_for(lib, lib.bfly_bus_id(index, bus, _BUS), "set-up (bus id)")
        info = [None] * size
        dist.all_gather_object(info, (handle.raw, bus.value, socket.gethostname()), group=group)
        hosts = [host for _, _, host in info]
        if len(set(hosts)) > 1:
            lib.bfly_free(own)
            raise RuntimeError(f"{what} set-up failed: the group's ranks run on hosts {hosts}; "
                               f"CUDA IPC maps buffers within one host only, so {layout}")
        bases = []
        try:
            for k, (raw, peer_bus, _) in enumerate(info):
                if k == rank:
                    bases.append(own.value)
                    continue
                peer = _I()
                _raise_for(lib, lib.bfly_device_of(peer_bus, ctypes.byref(peer)),
                           f"set-up (rank {k}'s card {peer_bus.decode()} is not visible here)")
                if peer.value != index:
                    ok = _I()
                    _raise_for(lib, lib.bfly_can_access_peer(index, peer.value, ctypes.byref(ok)),
                               "set-up (peer access)")
                    if not ok.value:
                        raise RuntimeError(
                            f"{what} set-up failed: card {index} cannot reach rank {k}'s card "
                            f"{peer.value} (cudaDeviceCanAccessPeer is false)")
                ptr = _P()
                _raise_for(lib, lib.bfly_open(raw, ctypes.byref(ptr)),
                           f"mapping rank {k}'s buffer (cudaIpcOpenMemHandle)")
                bases.append(ptr.value)
        except BaseException:
            for k, base in enumerate(bases):
                if k != rank:
                    lib.bfly_close(base)
            lib.bfly_free(own)
            raise
    return bases


def unshare_pages(lib, group, device, bases: list) -> None:
    """Undo :func:`share_pages`: close every mapping behind a barrier, then
    free this rank's own memory, so that no rank frees memory that a peer
    still reads or maps. A collective."""
    rank = dist.get_rank(group)
    torch.cuda.synchronize(device)
    dist.barrier(group=group)  # no rank's kernel still reads a peer's page
    for k, base in enumerate(bases):
        if k != rank:
            _raise_for(lib, lib.bfly_close(base), "teardown (cudaIpcCloseMemHandle)")
    dist.barrier(group=group)  # no rank maps another's memory
    _raise_for(lib, lib.bfly_free(bases[rank]), "teardown (cudaFree)")


# Every set of shared pages of this process, in the order built: B7's
# communicators (keyed by their clause group) and the device loop's
# exchange pages (ops/device_loop.py MeshPeers).
_COMMS: dict = {}


def communicator(group, device) -> Communicator:
    """This process's :class:`Communicator` for ``group`` (built at its
    first use)."""
    comm = _COMMS.get(group)
    if comm is None:
        comm = _COMMS[group] = Communicator(group, device)
    elif comm.device != torch.device(device):
        raise ValueError(f"the clause group's B7 buffers are on {comm.device}, not {device}")
    return comm


def close_all() -> None:
    """Close every communicator and every set of the device loop's exchange
    pages of this process, in the order they were built (the same on every
    rank): call before the process group goes."""
    for comm in list(_COMMS.values()):
        comm.close()


def pointers(parts: list, shape, device, dtype=torch.float32) -> "ctypes.Array":
    """The device pointers of the S partials ``parts`` (rank order) as a C
    array, each checked: a contiguous CUDA tensor of ``shape`` and ``dtype``
    (float32 for the fused readers) on ``device``. What a kernel that reads
    S slots itself takes."""
    if not 1 <= len(parts) <= MAX_RANKS:
        raise ValueError(f"1 to {MAX_RANKS} partials, not {len(parts)}")
    for p in parts:
        if (p.device != device or p.dtype != dtype or not p.is_contiguous()
                or tuple(p.shape) != tuple(shape)):
            raise ValueError(f"a partial is {tuple(p.shape)} {p.dtype} on {p.device}; the kernel "
                             f"reads contiguous {tuple(shape)} {dtype} on {device}")
    return (_P * len(parts))(*(p.data_ptr() for p in parts))


def tree_cuda(parts: list, zones=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B7's kernel alone on the current stream, with no flag and no group:
    the S partials ``parts`` (contiguous CUDA tensors of one shape and
    dtype, float32 or float64, rank order, any S from 1 to 64) combined in
    the tree order into ``out`` (allocated when None), which is returned.
    What a call costs on the card without its waits; the card tests and
    chip_smoke.py hold it against :func:`combine_parts`."""
    first = parts[0]
    if first.device.type != "cuda":
        raise ValueError(f"B7's kernel runs on CUDA tensors, not {first.device}")
    check_dtype(first.dtype)
    ptrs = pointers(parts, first.shape, first.device, first.dtype)
    period, n_max = zone_args(zones, first.numel())
    if out is None:
        out = torch.empty_like(first)
    pointers([out], first.shape, first.device, first.dtype)
    lib, _ = load_library()
    index = first.device.index if first.device.index is not None else torch.cuda.current_device()
    call = getattr(lib, "bfly_tree" + FORMS[first.dtype])
    with torch.cuda.device(index):
        rc = call(ptrs, len(parts), out.data_ptr(), first.numel(), period, n_max,
                  torch.cuda.get_device_properties(index).multi_processor_count,
                  torch.cuda.current_stream(first.device).cuda_stream)
    _raise_for(lib, rc, "kernel")
    _count(first.dtype)
    return out


def butterfly_cuda(t: torch.Tensor, group, zones=None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The standalone B7 call over ``group`` on the current stream: ``t``,
    a contiguous float32 or float64 CUDA tensor of the same shape and dtype
    on every rank, copied
    into this rank's slot of the call (after the wait for the peers' earlier
    launches) and combined in the tree order into ``out`` (allocated when
    None), which is returned on every rank. ``out`` may be ``t``. A
    collective: every rank of the group calls it, in the same order. Raises
    for anything the kernel does not take; never falls back."""
    if t.device.type != "cuda":
        raise ValueError(f"B7's kernel runs on CUDA tensors, not {t.device}")
    check_dtype(t.dtype)
    if not t.is_contiguous():
        raise ValueError("B7 reduces a contiguous buffer")
    if group is None:
        raise ValueError("B7 needs the clause group")
    if _group_size(group) == 1:
        return t if out is None else out.copy_(t)
    comm = communicator(group, t.device)
    comm.begin(t.shape, t.dtype)
    comm.wait()
    slot = comm.slot(t.shape, t.dtype)
    if slot.data_ptr() != t.data_ptr():
        slot.copy_(t)
    return comm.reduce(slot, zones, out)


def butterfly(t: torch.Tensor, group, zones=None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B7 for ``t``'s device: the standalone kernel call for a CUDA tensor,
    the plain version for a CPU tensor (copied into ``out`` when one is
    given); anything else raises."""
    if t.device.type == "cuda":
        return butterfly_cuda(t, group, zones, out)
    if t.device.type == "cpu":
        res = butterfly_plain(t, group, zones)
        return res if out is None else out.copy_(res)
    raise ValueError(f"no B7 path for tensors on {t.device}")
