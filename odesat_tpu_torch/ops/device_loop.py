"""The on-device multi-chunk loop: up to ``bound`` chunks of a chunk kernel
(B1, B2, B3 or B4) in one host launch of a CUDA graph that stops on the
card, and its plain version.

Replaces the ``lax.while_loop`` of ``odesat_tpu/models/ode.py:443-538``
(``make_multi_chunk_runner``) and ``odesat_tpu/models/stoch.py:267-309``
(``make_multi_stoch_runner``), which ``odesat_tpu/utils/tts.py:180-232``
runs as its one dispatch: before each chunk the loop tests whether any row
(every row, with ``stop_all``) is done and stops if so, and
``steps_advanced`` is the chunks run times the chunk's steps.

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
barrier and writes them after its last), so a chunk needs no copy. A
dispatch copies the incoming state into the loop's buffers and returns a
copy of them, so what it returns stays the caller's.

The stoch kernels draw one 31-bit seed a launch. A captured body cannot
take a new scalar each chunk, so B3 and B4 read theirs on the card from
the loop's seed table at the loop's chunk count: the dispatch draws
``bound`` seeds from the runner's generator, one at a time in the host
loop's order, and copies them to the card before the launch. The chunks
that run use the host loop's seeds, flip for flip. A dispatch that runs
every chunk leaves the generator where the host loop leaves it; one that
stops early has drawn seeds it did not use, and it ends the search.

What bounds it: nothing of the card's rates (the head reads B done bytes
a dispatch, the decide kernel three words a chunk); what it removes is the
host between chunks.

The plain version is ``models/loop.run_chunks``, the host loop of the same
rule, over the kernels' plain versions on the CPU. There is no fallback on
the card: a graph that cannot be built raises with the CUDA error.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from odesat_tpu_torch.ops import _cuda

# Graph launches (dispatches) made through :func:`run` in this process. A
# plain integer that callers may reset; the chunk kernels' own counts grow
# by the chunks each dispatch ran.
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
CTRL_WORDS = 4  # bound, ran, stop, spare (csrc/device_loop.cu)


@dataclasses.dataclass(eq=False)
class KernelChunk:
    """A chunk kernel's runner (B1, B2, B3 or B4), the one form the
    multi-chunk runners and ``solve_exact`` take to the device loop.

    Calling it runs ``fn``: one chunk, through the kernel on a CUDA state
    and its plain version on a CPU one. ``body(buffers, stream, stop,
    stop_all, seeds, seed_index)`` launches the kernel once in place on the
    loop's buffers while the loop captures ``stream``, and returns what the
    graph must keep alive. ``chunk_steps`` is a chunk's length, ``counter``
    the ``(module, attribute)`` of the kernel's launch count, ``spec`` its
    tables, and ``generator`` (B3's and B4's runners) the CPU generator
    their seeds come from. ``loops`` holds the graphs built for it."""

    fn: Callable
    body: Callable
    chunk_steps: int
    counter: tuple
    spec: object = None
    generator: torch.Generator | None = None
    loops: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    def __call__(self, *args):
        return self.fn(*args)

    def count(self, n: int) -> None:
        """Add ``n`` launches of the kernel made inside a graph, which runs
        them without the wrapper that counts the others."""
        module, attr = self.counter
        setattr(module, attr, getattr(module, attr) + n)


def _declare(lib) -> None:
    lib.device_loop_create.argtypes = [ctypes.POINTER(_P), _P, _P, _I, _I]
    lib.device_loop_create.restype = _I
    lib.device_loop_begin_body.argtypes = [_P, ctypes.POINTER(_P)]
    lib.device_loop_begin_body.restype = _I
    lib.device_loop_end_body.argtypes = [_P]
    lib.device_loop_end_body.restype = _I
    lib.device_loop_launch.argtypes = [_P, _P]
    lib.device_loop_launch.restype = _I
    lib.device_loop_destroy.argtypes = [_P]
    lib.device_loop_destroy.restype = None
    lib.device_loop_error_string.argtypes = [_I]
    lib.device_loop_error_string.restype = ctypes.c_char_p


def load_library():
    """Build (at first use) and load the loop's kernels. Returns ``(lib,
    build)``."""
    return _cuda.load("device_loop", _declare)


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"device loop: {what} failed: "
                           + lib.device_loop_error_string(rc).decode())


class DeviceLoop:
    """One graph: the :class:`KernelChunk` ``chunk`` over a state of
    ``state``'s shapes, stopping on any (``stop_all``: every) row done,
    with room for ``capacity`` seeds when ``seeded`` (B3, B4)."""

    def __init__(self, chunk, state, stop_all: bool, seeded: bool, capacity: int):
        self.lib, _ = load_library()
        self.handle = None
        device = state.v.device
        self.buffers = type(state)(*(torch.empty_like(t) for t in state))
        self.ctrl = torch.zeros(CTRL_WORDS, dtype=torch.int32, device=device)
        self.host = torch.zeros(1 + capacity, dtype=torch.int32).pin_memory()
        self.seeds = (torch.zeros(capacity, dtype=torch.int32, device=device) if seeded else
                      None)
        self.capacity = capacity
        ctrl = self.ctrl.data_ptr()
        handle = _P()
        with torch.cuda.device(device):
            _check(self.lib, self.lib.device_loop_create(
                ctypes.byref(handle), ctrl, self.buffers.done.data_ptr(),
                self.buffers.v.shape[0], int(stop_all)), "graph creation")
            self.handle = handle
            stream = _P()
            _check(self.lib, self.lib.device_loop_begin_body(handle, ctypes.byref(stream)),
                   "body capture")
            try:
                self.keep = chunk.body(
                    self.buffers, stream.value, ctrl + 8, stop_all,
                    self.seeds.data_ptr() if seeded else 0, ctrl + 4 if seeded else 0)
            except BaseException:
                self.lib.device_loop_end_body(handle)  # ends the capture; the launch's error stands
                raise
            _check(self.lib, self.lib.device_loop_end_body(handle), "graph instantiation")

    def __call__(self, state, bound: int, seeds=None):
        """One dispatch from ``state``; returns ``(state, chunks_run)``."""
        global launches
        for name, dst, src in zip(state._fields, self.buffers, state):
            if src.shape != dst.shape or src.dtype != dst.dtype or src.device != dst.device:
                raise ValueError(f"state.{name} is {tuple(src.shape)} {src.dtype} on "
                                 f"{src.device}; this loop's graph holds {tuple(dst.shape)} "
                                 f"{dst.dtype} on {dst.device}")
            dst.copy_(src)
        self.host[0] = bound
        n = 1
        if self.seeds is not None:
            n += bound
            self.host[1:n] = torch.as_tensor(seeds, dtype=torch.int32)
        device = state.v.device
        with torch.cuda.device(device):
            self.ctrl[:1].copy_(self.host[:1], non_blocking=True)
            if n > 1:
                self.seeds[:n - 1].copy_(self.host[1:n], non_blocking=True)
            _check(self.lib, self.lib.device_loop_launch(
                self.handle, torch.cuda.current_stream(device).cuda_stream), "graph launch")
        launches += 1
        ran = int(self.ctrl[1].item())  # the dispatch's one read: waits for the graph
        return type(state)(*(t.clone() for t in self.buffers)), ran

    def __del__(self):
        if getattr(self, "handle", None) is not None:
            self.lib.device_loop_destroy(self.handle)
            self.handle = None


def run(chunk: KernelChunk, state, bound: int, stop_all: bool = False, seeds=None):
    """Up to ``bound`` launches of the kernel runner ``chunk`` (B1 or B2;
    B3 or B4 with one seed a chunk in ``seeds``, ``bound`` of them) from the
    CUDA ``state``, in one graph launch; returns ``(state,
    steps_advanced)``. The graph is built at the runner's first dispatch at
    this batch size and stop rule, and reused for every bound."""
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
        return type(state)(*(t.clone() for t in state)), (0 if stop_all else bound) * \
            chunk.chunk_steps
    key = (B, bool(stop_all), state.v.device)
    loop = chunk.loops.get(key)
    if loop is None or (seeded and loop.capacity < bound):
        chunk.loops.pop(key, None)
        loop = chunk.loops[key] = DeviceLoop(chunk, state, stop_all, seeded,
                                             max(bound, 1) if seeded else 0)
    out, ran = loop(state, bound, seeds)
    chunk.count(ran)
    return out, ran * chunk.chunk_steps
