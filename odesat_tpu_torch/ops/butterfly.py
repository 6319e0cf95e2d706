"""The butterfly all-reduce over a clause group (kernel B7): a hand-written
CUDA kernel for Hopper over CUDA IPC buffers, and its plain version.

Replaces the TPU kernel ``odesat_tpu/ops/butterfly.py::butterfly_allreduce``
(:99), which the whole-chunk clause-shard kernels B6 and B9 ran inside
themselves: round r swapped the accumulator with partner ``index ^ 2^r`` over
ICI remote DMA, so every shard added in the same pairwise order and ended
with the same bits. Here the ranks of a clause group are processes and the
chunk is a sequence of launches (``ops/shard_chunk.py``,
``ops/stoch_chunk.py``); B7 runs between two launches, on the card, with no
host and no library collective in the way (``csrc/butterfly.cu``).

What every version computes (:func:`butterfly_plain` defines it): each of the
S ranks holds a float32 partial of the same shape; every rank gets the same
result, bit for bit: the partials in rank order combined as a pairwise tree,
level by level, ``(a0 + a1)`` at S = 2, ``(a0 + a1) + (a2 + a3)`` at S = 4,
an absent partner skipped at an S that is not a power of two (``(a0 + a1) +
a2`` at S = 3). IEEE addition is commutative, so this is the order in which
the TPU kernel's log2(S) rounds add. ``zones``, ``None`` or ``(period,
n_max)``, names a max zone: the last ``n_max`` words of every ``period``
words of the flat buffer combine by max instead of sum (JAX's ``combine``
max-combines the error zone of the adaptive pass), NaN propagating as in
``torch.maximum`` (the result is the canonical quiet NaN) and, of two equal
values (+0 and -0), the lower rank's kept. One B7 call stands for one
invocation of the JAX butterfly: a fixed B6 step and a B9 step make one, an
adaptive B6 step two.

The design on the card (:class:`Communicator`, one a clause group):

* **Buffers shared once.** At a group's first call, and again only when a
  buffer must grow, each rank allocates one device buffer in the extension
  (``cudaMalloc``, so an IPC handle names exactly it, whatever torch's
  caching allocator does, expandable segments included), holding a page
  of flags and two partial slots,
  and exports it with ``cudaIpcGetMemHandle``; the handles travel once over
  the group (``all_gather_object``) and the peers map them with
  ``cudaIpcOpenMemHandle``. A peer on another card must be reachable
  (``cudaDeviceCanAccessPeer``), else set-up raises. Every mapping is closed
  behind barriers before any rank frees its buffer (:meth:`Communicator.close`,
  called by a growth, by :func:`close_all` and by ``parallel/launch.py``'s
  worker exit). A process cannot open its own handle; at S = 1 there is no
  call.
* **Waits in the stream, never on an SM.** Call i: the pass has written
  the partial into slot ``i % 2``; ``cuStreamWriteValue32`` raises the rank's
  flag to i + 1 (behind a memory fence); ``cuStreamWaitValue32`` waits for
  every peer's flag to reach i + 1; the kernel reads the S partials and
  writes the result into a buffer private to the rank. Without MPS the
  contexts of ranks that share a card are time-sliced, so a kernel spinning
  on a peer's flag would hold the slice the peer needs.
* **No rank writes a slot that a peer may still read.** The flags carry the
  call count, not a parity bit. Rank r overwrites slot p at call i + 2 only
  after its wait of call i + 1 saw every peer's count at i + 2 or above; a
  peer raises its count to i + 2 only after its own reduction of call i,
  which read slot p, has completed in stream order. This is the JAX
  module's "same-parity reuse" argument (its :38-42) with counts in place of
  its parity flushes, which are not needed. The result never goes back into
  a shared slot, so B6 and B9 take the reduced buffer (read by the apply
  prologue) and the partial slot (written by the pass) as two pointers.

A rank's calls must follow its peers' in kind and order (as B6's and B9's
runners do on every rank); a buffer size a group has not seen yet is agreed
over the group first, and a size that differs between ranks raises on every
rank. The wrappers raise and never fall back: :func:`butterfly_cuda` takes
CUDA tensors only, :func:`butterfly_plain` is the CPU path and the
reference, and :func:`butterfly` picks by the tensor's device.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.distributed as dist

from odesat_tpu_torch.ops import _cuda

# B7 launches made through butterfly_cuda in this process. A plain integer
# that callers may reset; chip_smoke.py reads it.
launches = 0

MAX_RANKS = 64  # csrc/butterfly.cu kMaxRanks
FLAG_BYTES = 256  # the flag page at the head of a rank's buffer
_ALIGN = 64  # floats: slots start on 256-byte boundaries
_HANDLE = 64  # CUDA_IPC_HANDLE_SIZE
_BUS = 32

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
    lib.bfly_reduce.argtypes = [_P, _P, _I, _I, ctypes.c_uint, _P, _L, _L, _L, _I, _P]
    for name in ("bfly_init", "bfly_check_mem_ops", "bfly_alloc", "bfly_free", "bfly_open",
                 "bfly_close", "bfly_bus_id", "bfly_device_of", "bfly_can_access_peer",
                 "bfly_reduce"):
        getattr(lib, name).restype = _I
    lib.bfly_error_string.argtypes = [_I]
    lib.bfly_error_string.restype = ctypes.c_char_p


def load_library():
    """Build (at first use) and load ``csrc/butterfly.cu``. Returns ``(lib,
    build)``."""
    return _cuda.load("butterfly", _declare)


def _raise_for(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"B7 {what} failed: {lib.bfly_error_string(rc).decode()}")


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


def _agree(group, what) -> None:
    """Raise on every rank unless every rank of ``group`` passes the same
    ``what`` (a shape; one small collective)."""
    seen = [None] * _group_size(group)
    dist.all_gather_object(seen, what, group=group)
    if any(s != seen[0] for s in seen):
        raise ValueError(f"the ranks of the clause group pass buffers of shapes {seen}; B7 "
                         "takes one shape on every rank")


def butterfly_plain(t: torch.Tensor, group, zones=None) -> torch.Tensor:
    """B7 in torch ops: every rank's ``t`` gathered over ``group``
    (``dist.all_gather``; through the host for CUDA tensors on gloo) and
    combined on the CPU in the butterfly's tree order (:func:`combine`);
    returned on ``t``'s device, a new tensor of its shape. A collective:
    every rank of the group calls it together. A shape that differs between
    ranks raises on every rank."""
    if t.dtype != torch.float32:
        raise ValueError(f"B7 reduces float32 buffers, not {t.dtype}")
    if _group_size(group) == 1:
        return t.clone()
    _agree(group, (tuple(t.shape), zone_args(zones, t.numel())))
    where = t.device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    flat = t.detach().reshape(-1).to(where)
    parts = [torch.empty_like(flat) for _ in range(_group_size(group))]
    dist.all_gather(parts, flat.contiguous(), group=group)
    return combine([p.cpu() for p in parts], zones).reshape(t.shape).to(t.device)


# ---------------------------------------------------------------- kernel


class _Raw:
    """A device pointer as torch takes one (``__cuda_array_interface__``):
    float32 words, not owned."""

    def __init__(self, ptr: int, numel: int):
        self.__cuda_array_interface__ = {"shape": (numel,), "typestr": "<f4",
                                         "data": (ptr, False), "version": 2}


class Communicator:
    """B7 for one clause group on this rank's card: the shared buffers, the
    call count and the launches. Built by :func:`communicator`."""

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
        self.cap = 0  # floats a slot
        self.count = 0  # calls since the buffers were mapped
        self.agreed: set = set()  # buffer sizes the group has agreed on
        self.bases: list = []  # every rank's buffer in this process (rank order)

    # -- set-up and teardown

    def _map(self, numel: int) -> None:
        """Allocate, export, exchange and map the buffers for slots of at
        least ``numel`` floats."""
        self._unmap()
        cap = -(-max(numel, 1) // _ALIGN) * _ALIGN
        lib = self.lib
        own, handle = _P(), ctypes.create_string_buffer(_HANDLE)
        with torch.cuda.device(self.index):
            _raise_for(lib, lib.bfly_alloc(FLAG_BYTES + 2 * 4 * cap, ctypes.byref(own), handle),
                       "allocation (cudaMalloc, cudaIpcGetMemHandle)")
            bus = ctypes.create_string_buffer(_BUS)
            _raise_for(lib, lib.bfly_bus_id(self.index, bus, _BUS), "set-up (bus id)")
            info = [None] * self.size
            dist.all_gather_object(info, (handle.raw, bus.value), group=self.group)
            bases = []
            try:
                for k, (raw, peer_bus) in enumerate(info):
                    if k == self.rank:
                        bases.append(own.value)
                        continue
                    peer = _I()
                    _raise_for(lib, lib.bfly_device_of(peer_bus, ctypes.byref(peer)),
                               f"set-up (rank {k}'s card {peer_bus.decode()} is not visible "
                               "here)")
                    if peer.value != self.index:
                        ok = _I()
                        _raise_for(lib, lib.bfly_can_access_peer(self.index, peer.value,
                                                                 ctypes.byref(ok)),
                                   "set-up (peer access)")
                        if not ok.value:
                            raise RuntimeError(
                                f"B7 set-up failed: card {self.index} cannot reach rank {k}'s "
                                f"card {peer.value} (cudaDeviceCanAccessPeer is false)")
                    ptr = _P()
                    _raise_for(lib, lib.bfly_open(raw, ctypes.byref(ptr)),
                               f"mapping rank {k}'s buffer (cudaIpcOpenMemHandle)")
                    bases.append(ptr.value)
            except BaseException:
                for k, base in enumerate(bases):
                    if k != self.rank:
                        lib.bfly_close(base)
                lib.bfly_free(own)
                raise
        self.bases, self.cap, self.count = bases, cap, 0
        self.flags = (_P * self.size)(*bases)
        slots = [[base + FLAG_BYTES + p * 4 * cap for base in bases] for p in (0, 1)]
        self.own_slots = [s[self.rank] for s in slots]
        self.parts = [(_P * self.size)(*s) for s in slots]
        with torch.cuda.device(self.index):
            self.views = [torch.as_tensor(_Raw(ptr, cap), device=self.device)
                          for ptr in self.own_slots]

    def _unmap(self) -> None:
        """Close every mapping behind a barrier, then free this rank's
        buffer: no rank frees memory that a peer still reads or maps."""
        if not self.bases:
            return
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)  # no rank's reduction still reads a slot
        for k, base in enumerate(self.bases):
            if k != self.rank:
                _raise_for(self.lib, self.lib.bfly_close(base), "teardown (cudaIpcCloseMemHandle)")
        dist.barrier(group=self.group)  # no rank maps another's buffer
        own = self.bases[self.rank]
        self.bases, self.views, self.cap = [], None, 0
        _raise_for(self.lib, self.lib.bfly_free(own), "teardown (cudaFree)")

    def close(self) -> None:
        """Unmap and free this group's buffers (a collective over the
        group)."""
        self._unmap()
        self.agreed.clear()
        _COMMS.pop(self.group, None)


    # -- calls

    def slot(self, shape) -> torch.Tensor:
        """The shared slot of the next call, as a contiguous float32 tensor
        of ``shape``: the pass writes its partial there."""
        numel = math.prod(shape)
        if numel not in self.agreed:
            _agree(self.group, numel)
            if numel > self.cap:
                self._map(numel)
            self.agreed.add(numel)
        return self.views[self.count % 2][:numel].view(tuple(shape))

    def reduce(self, part: torch.Tensor, zones=None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Enqueue call ``count`` on the current stream: ``part`` must be
        :meth:`slot`'s tensor of this call; the result goes to ``out``
        (allocated when None), which is returned."""
        global launches
        p = self.count % 2
        if part.data_ptr() != self.own_slots[p] or part.numel() not in self.agreed:
            raise ValueError("B7 reduces the communicator's slot of this call (slot(shape))")
        period, n_max = zone_args(zones, part.numel())
        if out is None:
            out = torch.empty(part.shape, dtype=torch.float32, device=self.device)
        if (out.device != self.device or out.dtype != torch.float32 or not out.is_contiguous()
                or out.shape != part.shape):
            raise ValueError(f"out is {tuple(out.shape)} {out.dtype} on {out.device}; B7 writes "
                             f"a contiguous {tuple(part.shape)} float32 on {self.device}")
        if {out.data_ptr()} & set(self.own_slots):
            raise ValueError("B7 writes its result into a buffer of its own, not a slot")
        with torch.cuda.device(self.index):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = self.lib.bfly_reduce(self.parts[p], self.flags, self.size, self.rank,
                                      self.count & 0xFFFFFFFF, out.data_ptr(), part.numel(),
                                      period, n_max, self.sms, stream)
        _raise_for(self.lib, rc, "call")
        self.count += 1
        launches += 1
        return out


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
    """Close every communicator of this process, in the order they were
    built (the same on every rank): call before the process group goes."""
    for comm in list(_COMMS.values()):
        comm.close()


def butterfly_cuda(t: torch.Tensor, group, zones=None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B7 over ``group`` on the current stream: ``t``, a contiguous float32
    CUDA tensor of the same shape on every rank, combined in the tree order
    into ``out`` (allocated when None), which is returned on every rank. A
    ``t`` that is not the group's slot of this call is copied into it first.
    A collective: every rank of the group calls it, in the same order.
    Raises for anything the kernel does not take; never falls back."""
    if t.device.type != "cuda":
        raise ValueError(f"B7's kernel runs on CUDA tensors, not {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"B7 reduces a contiguous float32 buffer, not {t.dtype} "
                         f"(contiguous: {t.is_contiguous()})")
    if group is None:
        raise ValueError("B7 needs the clause group")
    if _group_size(group) == 1:
        return t if out is None else out.copy_(t)
    comm = communicator(group, t.device)
    slot = comm.slot(t.shape)
    if slot.data_ptr() != t.data_ptr():
        slot.copy_(t)
    return comm.reduce(slot, zones, out)


def butterfly(t: torch.Tensor, group, zones=None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B7 for ``t``'s device: the kernel for a CUDA tensor, the plain
    version for a CPU tensor (copied into ``out`` when one is given);
    anything else raises."""
    if t.device.type == "cuda":
        return butterfly_cuda(t, group, zones, out)
    if t.device.type == "cpu":
        res = butterfly_plain(t, group, zones)
        return res if out is None else out.copy_(res)
    raise ValueError(f"no B7 path for tensors on {t.device}")
