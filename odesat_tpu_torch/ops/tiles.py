"""The interleaved tile layout of the clause-mesh chunk kernels B6
(``ops/shard_chunk.py``) and B9 (``ops/stoch_chunk.py``), as
``csrc/tile.cuh`` reads it.

A chunk runner changes the layout of the rows it advances once at entry
and once at exit: a ``(B, *X)`` buffer becomes ``(ceil(B/R), *X, R)``,
tile ``g`` holding rows ``g*R .. g*R+R-1`` with the row index innermost, so
that neighbouring lanes of the card take neighbouring trajectories of the
same clause or variable. The last tile of a ragged batch is padded with
rows the caller fills (done rows, which nothing advances); every row is
computed on its own, so a padded row never changes a real one. The public
functions keep the JAX package's ``(B, *X)`` layout.

The chunk runners consume their input, as JAX's donated state
(``ops/device_loop.py`` states the contract), and tile it where it lies
(:func:`tile_`, :func:`untile_`): for a full batch (B a multiple of R)
tile ``g`` of a contiguous ``(B, *X)`` field is already one contiguous
block of ``R * X`` elements, and tiling it is the transpose of an ``R x X``
matrix within that block, done a wave of tiles at a time through a staging
buffer of whole tiles (:data:`STAGING_BYTES`). A field that cannot be
tiled where it lies (a ragged batch, which has no room for the padding
rows; a non-contiguous field; one whose storage another field shares) is
copied into a buffer held for its shape and copied back into the caller's
tensor at exit (:class:`Tiles`).

What a runner holds (the tiles' buffers, its launches' staging and
scratch) does not depend on its chunk length, and a solve builds a runner
for each length it runs (its inner chunk, a tail, the grown chunks), and
runs them one at a time: the formula's runners share one pool
(:func:`held_pool`), a set for each batch shape, which goes with the last
of them.
"""

from __future__ import annotations

import logging
import math
import weakref
from typing import Optional

import torch

logger = logging.getLogger(__name__)

TILE = 32  # trajectories (chains) a tile, csrc/tile.cuh kR: one 128-byte line of f32 a gather
# the staging buffer of the in-place tiling: whole tiles of the widest field,
# at least one (config 7's xs tile, 32 x 43,776 f32, is 5.6 MB: two a wave,
# beside a state of about 0.40 GB)
STAGING_BYTES = 16 << 20


class _Pool(dict):
    """A dict that a weak reference can name."""


_POOLS: dict = {}  # id(owner) -> (a weak reference to the owner, one to its pool)


def held_pool(owner) -> dict:
    """The pool of buffers that the clause mesh's chunk runners of
    ``owner`` (a formula's arrays) hold: a dict, keyed by what a runner
    holds a set for (its kernel, shard and batch shape, never its chunk
    length), that every runner of the formula built while another lives
    shares. Each runner keeps its pool, so the pool lives as long as one
    of them does: a solve's runners (its inner chunk, the tails, the grown
    chunks) share it, and it goes with them. The runners of a pool run one
    at a time, as a solve runs them: a set is in use only during a call."""
    key = id(owner)
    hit = _POOLS.get(key)
    pool = hit[1]() if hit is not None and hit[0]() is owner else None
    if pool is None:
        pool, entry = _Pool(), []

        def forget(ref, key=key, entry=entry):
            if _POOLS.get(key) is entry[0]:
                del _POOLS[key]

        entry.append((weakref.ref(owner, forget), weakref.ref(pool, forget)))
        _POOLS[key] = entry[0]
    return pool


def n_tiles(B: int, R: int = TILE) -> int:
    return -(-B // R)


def tile(x: torch.Tensor, R: int = TILE, fill=0) -> torch.Tensor:
    """``(B, *X) -> (ceil(B/R), *X, R)``, a new contiguous tensor; the
    last tile's missing rows are ``fill``."""
    B = x.shape[0]
    pad = n_tiles(B, R) * R - B
    if pad:
        x = torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])
    # a copy even where the reshape is a view (a full 1-D batch): the
    # kernels write the tiles in place
    return x.reshape(-1, R, *x.shape[1:]).movedim(1, -1).clone(
        memory_format=torch.contiguous_format)


def untile(x: torch.Tensor, B: int) -> torch.Tensor:
    """``(G, *X, R) -> (B, *X)``: the first ``B`` rows, a new contiguous
    tensor."""
    return x.movedim(-1, 1).reshape(-1, *x.shape[1:-1])[:B].clone(
        memory_format=torch.contiguous_format)


def rows_of(x: torch.Tensor) -> int:
    """The rows a tiled buffer holds, padding included."""
    return x.shape[0] * x.shape[-1]


# ------------------------------------------------------------ in place


def _waves(flat: torch.Tensor, G: int, R: int, X: int, staging: torch.Tensor,
           to_tiles: bool) -> None:
    """Transpose each of the ``G`` contiguous ``R x X`` blocks of ``flat``
    (``X x R`` when not ``to_tiles``) where it lies, a wave of as many
    blocks as ``staging`` (bytes) holds at a time: a copy into it, then
    the transpose back."""
    buf = staging.view(torch.uint8).view(flat.dtype)
    k = min(G, buf.numel() // (R * X))
    if k < 1:
        raise ValueError(f"a staging buffer of {staging.numel()} bytes holds no tile of "
                         f"{R} x {X} {flat.dtype}")
    rows, cols = (R, X) if to_tiles else (X, R)
    for g in range(0, G, k):
        n = min(k, G - g)
        block = flat[g * R * X:(g + n) * R * X].view(n, R * X)
        stage = buf[:n * R * X].view(n, R * X)
        stage.copy_(block)
        block.view(n, cols, rows).copy_(stage.view(n, rows, cols).transpose(1, 2))


def tile_(x: torch.Tensor, staging: Optional[torch.Tensor], R: int = TILE) -> torch.Tensor:
    """``(B, *X) -> (B/R, *X, R)`` in ``x``'s own storage, which must be
    contiguous with B a multiple of ``R``: :func:`tile` with no new tensor.
    ``staging`` is a byte buffer of at least one tile (1-D fields, a view,
    need none)."""
    B, X = x.shape[0], math.prod(x.shape[1:])
    if B % R or not x.is_contiguous():
        raise ValueError(f"tile_ takes a contiguous batch of a multiple of {R} rows, not "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    G = B // R
    if x.dim() > 1 and G and X:
        _waves(x.view(-1), G, R, X, staging, True)
    return x.view(G, *x.shape[1:], R)


def untile_(x: torch.Tensor, B: int, staging: Optional[torch.Tensor]) -> torch.Tensor:
    """The inverse of :func:`tile_`: contiguous tiles ``(G, *X, R) -> (B,
    *X)`` in ``x``'s own storage, ``B`` = G * R."""
    G, R = x.shape[0], x.shape[-1]
    if B != G * R or not x.is_contiguous():
        raise ValueError(f"untile_ takes the contiguous tiles of all {B} rows, not "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    X = math.prod(x.shape[1:-1])
    if x.dim() > 2 and G and X:
        _waves(x.view(-1), G, R, X, staging, False)
    return x.view(B, *x.shape[1:-1])


def tile_into(dst: torch.Tensor, x: torch.Tensor, fill=0) -> torch.Tensor:
    """``x`` (B, *X), any strides, tiled into ``dst`` (ceil(B/R), *X, R),
    the last tile's missing rows ``fill``: :func:`tile` into a buffer."""
    B, R = x.shape[0], dst.shape[-1]
    rows = dst.movedim(-1, 1)  # (G, R, *X), a view of dst
    full, rest = divmod(B, R)
    if full:
        rows[:full].copy_(x[:full * R].unflatten(0, (full, R)))
    if rest:
        rows[full, :rest].copy_(x[full * R:])
        rows[full, rest:].fill_(fill)
    return dst


def untile_into(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The first B rows of tiled ``src`` (G, *X, R) written into ``x`` (B,
    *X), any strides: :func:`untile` into the caller's tensor."""
    B, R = x.shape[0], src.shape[-1]
    rows = src.movedim(-1, 1)
    full, rest = divmod(B, R)
    if full:
        x[:full * R].unflatten(0, (full, R)).copy_(rows[:full])
    if rest:
        x[full * R:].copy_(rows[full, :rest])
    return x


def in_place(fields: dict, R: int = TILE) -> dict:
    """For each of a state's ``fields`` (name -> (B, *X) tensor), whether
    :func:`tile_` can take it where it lies: a batch of whole tiles, a
    contiguous tensor, and storage that no other field shares."""
    def key(t):
        return t.untyped_storage().data_ptr()

    count: dict = {}
    for t in fields.values():
        if t.numel():
            count[key(t)] = count.get(key(t), 0) + 1
    return {name: (t.shape[0] % R == 0 and t.is_contiguous()
                   and (t.numel() == 0 or count[key(t)] == 1))
            for name, t in fields.items()}


class Tiles:
    """A runner's tiles of a state for one batch shape, and the buffers it
    holds from one call to the next: the staging buffer of the in-place
    route and the tiled buffers of the held route (:func:`in_place`
    decides, field by field, and a DEBUG log line says what it chose).
    :meth:`tile` takes the caller's fields; :meth:`untile` writes the
    chunk's results back into them, in place from the caller's own tiles
    or straight from wherever a result lies (a held buffer, a kernel's
    scratch, a plain version's new tensors)."""

    def __init__(self, R: int = TILE, staging_bytes: int = STAGING_BYTES):
        self.R, self.staging_bytes = R, staging_bytes
        self.staging: Optional[torch.Tensor] = None
        self.held: dict = {}  # name -> the (G, *X, R) buffer of the held route
        self.entry: dict = {}  # name -> (the caller's tensor, its tiles in place or None)

    def tile(self, fields: dict, fills: Optional[dict] = None) -> dict:
        """``fields`` (name -> (B, *X) tensor) tiled: views of the caller's
        storage where :func:`in_place` allows it, else the held buffers
        holding tiled copies (padding rows ``fills[name]``, default 0)."""
        R, fills = self.R, fills or {}
        route = in_place(fields, R)
        widest = max((R * math.prod(t.shape[1:]) * t.element_size()
                      for name, t in fields.items() if route[name] and t.dim() > 1), default=0)
        if widest and (self.staging is None or self.staging.numel() < widest):
            first = next(iter(fields.values()))
            self.staging = torch.empty(widest * max(1, self.staging_bytes // widest),
                                       dtype=torch.uint8, device=first.device)
        logger.debug("tiles of %d rows: %s", next(iter(fields.values())).shape[0],
                     ", ".join(f"{n} {'in place' if r else 'held'}" for n, r in route.items()))
        out, self.entry = {}, {}
        for name, x in fields.items():
            if route[name]:
                out[name] = tile_(x, self.staging, R)
                self.entry[name] = (x, out[name])
                continue
            shape = (n_tiles(x.shape[0], R), *x.shape[1:], R)
            buf = self.held.get(name)
            if buf is None or tuple(buf.shape) != shape or buf.dtype != x.dtype:
                buf = self.held[name] = torch.empty(shape, dtype=x.dtype, device=x.device)
            out[name] = tile_into(buf, x, fills.get(name, 0))
            self.entry[name] = (x, None)
        return out

    def untile(self, results: dict) -> dict:
        """The chunk's tiled ``results`` (name -> tensor) written into the
        caller's tensors given to :meth:`tile`, which are returned."""
        out = {}
        for name, t in results.items():
            x, mine = self.entry[name]
            if mine is not None and t.data_ptr() == mine.data_ptr():
                untile_(mine, x.shape[0], self.staging)
            else:
                untile_into(x, t)
            out[name] = x
        self.entry = {}
        return out
