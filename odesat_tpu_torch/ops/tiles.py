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
"""

from __future__ import annotations

import torch

TILE = 32  # trajectories (chains) a tile, csrc/tile.cuh kR: one 128-byte line of f32 a gather


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
