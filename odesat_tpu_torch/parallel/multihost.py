"""Joining a ``torch.distributed`` world: the port of
``odesat_tpu.parallel.multihost.initialize_distributed``.

JAX joins a pod through ``jax.distributed.initialize`` and one process
drives all of a host's devices. Here every rank is its own process with one
device, and :func:`initialize_distributed` is what each rank calls: it
builds the store (a ``FileStore`` on a path, or a ``TCPStore`` on
``MASTER_ADDR:MASTER_PORT``, both given explicitly or through the usual
``RANK``/``WORLD_SIZE`` environment), always with a finite timeout, and
calls ``init_process_group`` with an explicit backend, rank and world size.

The JAX rule holds (its :38-40): a half-set cluster environment (``RANK``
without ``WORLD_SIZE``, a world size without an address) raises; it never
degrades to N disconnected single-process runs. Backend and device rules:

* ``nccl`` needs a card per rank on the host: more ranks than visible
  cards raises and names ``--dist-backend gloo``, the backend for ranks
  that share a card (NCCL refuses two ranks on one device);
* ``--device cpu`` requires ``gloo``;
* each rank binds ``cuda:(local_rank % device_count)``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def check_backend(backend: str, device: str, local_world_size: int) -> None:
    """Raise ValueError for a backend that cannot serve ``local_world_size``
    ranks of this host on ``device`` ("cuda" or "cpu")."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown distributed backend {backend!r} (nccl or gloo)")
    if device == "cpu" and backend != "gloo":
        raise ValueError("--device cpu needs --dist-backend gloo (nccl runs on CUDA only)")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_world_size > cards:
            raise ValueError(
                f"nccl needs one CUDA device per rank, but {local_world_size} ranks share "
                f"{cards} visible device(s) on this host; pass --dist-backend gloo for ranks "
                "that share a card"
            )


def _from_env():
    """(rank, world_size, local_rank, local_world_size, addr, port) from the
    environment, or None when none of it is set. A half-set environment
    raises."""
    present = [k for k in _ENV if os.environ.get(k)]
    if not present:
        return None
    missing = [k for k in _ENV if not os.environ.get(k)]
    if missing:
        raise RuntimeError(
            f"half-set cluster environment: {', '.join(present)} set but "
            f"{', '.join(missing)} missing; refusing to run as disconnected single processes"
        )
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return rank, world, local_rank, local_world, os.environ["MASTER_ADDR"], \
        int(os.environ["MASTER_PORT"])


def initialize_distributed(
    backend: str = "nccl",
    device: str = "cuda",
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    store_path: Optional[str] = None,
    local_rank: Optional[int] = None,
    local_world_size: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Optional[torch.device]:
    """Join the world and return this rank's device, or None (and join
    nothing) when neither arguments nor environment describe a world.

    With ``rank``/``world_size`` given, ``store_path`` names the
    ``FileStore`` file every rank shares (it must not be a stale one);
    otherwise the environment's ``MASTER_ADDR``/``MASTER_PORT`` host a
    ``TCPStore`` on rank 0."""
    if (rank is None) != (world_size is None):
        raise ValueError("rank and world_size are given together or not at all")
    addr = port = None
    if rank is None:
        env = _from_env()
        if env is None:
            return None
        rank, world_size, env_local, env_local_world, addr, port = env
        local_rank = env_local if local_rank is None else local_rank
        local_world_size = env_local_world if local_world_size is None else local_world_size
    elif store_path is None:
        raise ValueError("an explicit rank needs store_path (a FileStore shared by the ranks)")
    local_rank = rank if local_rank is None else local_rank
    local_world_size = world_size if local_world_size is None else local_world_size
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    check_backend(backend, device, local_world_size)

    timeout = datetime.timedelta(seconds=float(timeout_s))
    if store_path is not None:
        store = dist.FileStore(store_path, world_size)
    else:
        store = dist.TCPStore(addr, port, world_size, is_master=rank == 0, timeout=timeout)
    dev = torch.device("cpu")
    if device == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timeout)
    return dev
