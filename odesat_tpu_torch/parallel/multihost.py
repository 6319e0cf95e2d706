"""Joining a ``torch.distributed`` world, on one host or across hosts: the
port of ``odesat_tpu.parallel.multihost``.

JAX joins a pod through ``jax.distributed.initialize`` and one process
drives all of a host's devices. Here every rank is a process of its own
with one device, so a job has two levels:

* **a process of the job** (a host's controller, the CLI's parent): the
  coordinator form of :func:`initialize_distributed` (``coordinator``,
  ``num_processes``, ``process_id``, JAX's arguments) joins the job and
  returns its :class:`Pod`. Process 0 hosts a ``TCPStore`` on the
  coordinator's port for the whole run; every process publishes its local
  rank count ``L`` there and waits for all the others, and the processes
  agree through it on what must be the same everywhere (the seed).
  ``parallel/launch.spawn`` then starts this process's ``L`` ranks;
* **a rank**: :func:`initialize_distributed` with an explicit rank joins
  the world over the pod's store (``coordinator``, under a prefix a run),
  over a ``FileStore`` (``store_path``, one host), or over the usual
  ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` environment
  (``torchrun``; rank 0 hosts the ``TCPStore``), always with a finite
  timeout and an explicit backend.

A process's ranks are consecutive global ranks, ``process_id * L +
local_rank``, and :func:`make_pod_mesh` fills every clause group from one
process's ranks (it raises unless ``S`` divides ``L``), so B7's CUDA IPC
slots (``ops/butterfly.py``) never cross a host, and the trajectory axis
spans the processes: between chunks it all-reduces only the host loop's
done flags.

The JAX rule holds (its :38-40): a half-given coordinator or cluster
environment raises, an unreachable coordinator raises within the timeout,
and nothing degrades to N disconnected single-process runs. Backend and
device rules:

* ``nccl`` needs a card per rank on the host: more ranks than visible
  cards raises and names ``--dist-backend gloo``, the backend for ranks
  that share a card (NCCL refuses two ranks on one device);
* ``--device cpu`` requires ``gloo``;
* each rank binds ``cuda:(local_rank % device_count)``.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# This process's pod (the coordinator form), and its rank's local rank count
# and collective timeout.
_pod: Optional["Pod"] = None
_local_world_size: Optional[int] = None
_timeout_s: float = DEFAULT_TIMEOUT_S


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


def local_rank_count(backend: str, device: str) -> int:
    """``L``, the ranks a process of a pod starts: under ``nccl`` on CUDA
    the visible cards; for gloo ranks (sharing a card, or on the CPU)
    ``LOCAL_WORLD_SIZE``, the variable ``torchrun`` sets; else 1."""
    if backend == "nccl" and device == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    value = os.environ.get("LOCAL_WORLD_SIZE")
    if not value:
        return 1
    n = int(value)
    if n < 1:
        raise ValueError(f"LOCAL_WORLD_SIZE must be at least 1, not {n}")
    return n


def _address(coordinator: str) -> tuple:
    host, sep, port = str(coordinator).rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not HOST:PORT")
    return host, int(port)


def _store(coordinator: str, is_master: bool, timeout_s: float) -> dist.TCPStore:
    """A ``TCPStore`` on ``coordinator``: hosted here (``is_master``) or
    reached as a client, which raises RuntimeError unless the coordinator
    accepts a connection within ``timeout_s``. Every later wait on it is
    bounded by ``timeout_s``."""
    host, port = _address(coordinator)
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if is_master:
        return dist.TCPStore(host, port, None, True, timeout=timeout, wait_for_workers=False)
    # torch's client retries past its timeout (about twice it); a plain
    # connect first keeps the whole wait within timeout_s
    deadline = time.monotonic() + float(timeout_s)
    while True:
        left = deadline - time.monotonic()
        try:
            socket.create_connection((host, port), timeout=max(0.05, min(1.0, left))).close()
            break
        except OSError as e:
            if left <= 0:
                raise RuntimeError(f"the coordinator {coordinator} did not answer within "
                                   f"{timeout_s} s ({e}); refusing to run as disconnected "
                                   "single processes") from None
            time.sleep(min(0.2, max(left, 0.0)))
    store = dist.TCPStore(host, port, None, False,
                          timeout=datetime.timedelta(seconds=max(1.0, deadline -
                                                                 time.monotonic())))
    store.set_timeout(timeout)
    return store


class Pod:
    """This process's place in a job of ``num_processes`` processes, each
    starting ``local_world_size`` ranks (the same ``L`` everywhere), joined
    through the ``TCPStore`` that process 0 hosts on ``coordinator``.

    The processes must make the same calls in the same order: each
    :meth:`broadcast` and each spawned world (``parallel/launch.spawn``)
    belongs to the run numbered :attr:`runs`, which :meth:`finish` ends."""

    def __init__(self, coordinator: str, num_processes: int, process_id: int,
                 local_world_size: int, store):
        self.coordinator, self.num_processes, self.process_id = \
            coordinator, num_processes, process_id
        self.local_world_size, self.store = local_world_size, store
        self.runs = 0

    @property
    def world_size(self) -> int:
        return self.num_processes * self.local_world_size

    @property
    def first_rank(self) -> int:
        """The global rank of this process's first rank."""
        return self.process_id * self.local_world_size

    def prefix(self) -> str:
        """The store prefix of the current run's world."""
        return f"run{self.runs}/world"

    def broadcast(self, key: str, value: str) -> str:
        """Process 0's ``value`` for ``key`` in this run, on every process
        (the others' ``value`` is ignored; a wait bounded by the timeout)."""
        name = f"run{self.runs}/{key}"
        if self.process_id == 0:
            self.store.set(name, value)
        return self.store.get(name).decode()

    def finish(self) -> None:
        """End this run: every process says it is done, and process 0, which
        hosts the store, waits until all have (bounded by the timeout), so
        that no rank of the run loses the store."""
        self.store.set(f"run{self.runs}/done/{self.process_id}", "1")
        if self.process_id == 0:
            self.store.wait([f"run{self.runs}/done/{p}" for p in range(self.num_processes)])
        self.runs += 1

    def __repr__(self) -> str:
        return (f"Pod(process {self.process_id} of {self.num_processes}, "
                f"{self.local_world_size} ranks each, coordinator {self.coordinator})")


def current_pod() -> Optional[Pod]:
    """The pod this process joined (the coordinator form), or None."""
    return _pod


def _join(coordinator, num_processes, process_id, local_ranks: int, timeout_s: float) -> Pod:
    global _pod
    given = {"coordinator": coordinator, "num_processes": num_processes,
             "process_id": process_id}
    missing = [k for k, v in given.items() if v is None]
    if missing:
        raise ValueError(f"{', '.join(k for k in given if k not in missing)} given without "
                         f"{', '.join(missing)}; a multi-process job needs all three")
    if int(num_processes) < 1:
        raise ValueError(f"num_processes must be at least 1, not {num_processes}")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    if local_ranks < 1:
        raise ValueError(f"a process starts at least one rank, not {local_ranks}")
    P, pid = int(num_processes), int(process_id)
    store = _store(coordinator, pid == 0, timeout_s)
    store.set(f"process/{pid}", str(local_ranks))
    store.wait([f"process/{p}" for p in range(P)])
    counts = [int(store.get(f"process/{p}")) for p in range(P)]
    if len(set(counts)) != 1:
        raise ValueError(f"the processes start {counts} ranks; every process of a pod must "
                         "start the same number (LOCAL_WORLD_SIZE, or the visible cards)")
    _pod = Pod(str(coordinator), P, pid, local_ranks, store)
    return _pod


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
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    store_prefix: str = "",
):
    """Join a job, in one of three forms; every wait is bounded by
    ``timeout_s``.

    * **The coordinator form** (JAX's; ``rank`` None and any of
      ``coordinator``, ``num_processes``, ``process_id`` given: all three
      are then needed): join the job as process ``process_id`` of
      ``num_processes``, which starts ``local_world_size`` ranks
      (default :func:`local_rank_count` of ``backend`` and ``device``), and
      return its :class:`Pod`. Process 0 hosts the ``TCPStore`` on
      ``coordinator`` (``HOST:PORT``); the call returns once every process
      has joined. Raises ValueError for half-given or out-of-range
      arguments and for processes whose rank counts differ, RuntimeError
      for a coordinator that does not answer.
    * **A rank** (``rank`` and ``world_size`` given): join the world over
      the pod's store on ``coordinator`` (under ``store_prefix``, the run's
      :meth:`Pod.prefix`) or over the ``FileStore`` at ``store_path`` (it
      must not be a stale one), and return this rank's device.
    * **The environment** (no argument): ``MASTER_ADDR``/``MASTER_PORT``
      host a ``TCPStore`` on rank 0; returns the device, or None (and joins
      nothing) when the environment describes no world."""
    global _local_world_size, _timeout_s
    if rank is None and (coordinator, num_processes, process_id) != (None, None, None):
        ranks = local_world_size if local_world_size is not None else \
            local_rank_count(backend, device)
        check_backend(backend, device, ranks)
        return _join(coordinator, num_processes, process_id, ranks, timeout_s)
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
    elif store_path is None and coordinator is None:
        raise ValueError("an explicit rank needs store_path (a FileStore shared by the ranks) "
                         "or coordinator (its pod's TCPStore)")
    local_rank = rank if local_rank is None else local_rank
    local_world_size = world_size if local_world_size is None else local_world_size
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    check_backend(backend, device, local_world_size)

    timeout = datetime.timedelta(seconds=float(timeout_s))
    if coordinator is not None:
        store = dist.PrefixStore(store_prefix, _store(coordinator, False, timeout_s))
    elif store_path is not None:
        store = dist.FileStore(store_path, world_size)
    else:
        store = dist.TCPStore(addr, port, world_size, is_master=rank == 0, timeout=timeout)
    dev = torch.device("cpu")
    if device == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timeout)
    _local_world_size = local_world_size
    _timeout_s = float(timeout_s)
    return dev


def collective_timeout() -> float:
    """Seconds this rank's collectives and waits may take: the
    ``timeout_s`` it joined its world with (``--dist-timeout``; the
    default before it joined one). The device loop's stop exchange waits
    for its peers as long (``ops/device_loop.MeshPeers``)."""
    return _timeout_s


def check_clause_groups(local_world_size: int, n_clause: int) -> None:
    """Raise ValueError unless ``n_clause`` divides a process's
    ``local_world_size`` ranks, so that every clause group of a pod's mesh
    lies inside one process."""
    if n_clause < 1 or local_world_size % n_clause:
        raise ValueError(f"{local_world_size} ranks a process not divisible by "
                         f"clause={n_clause}: a clause group would span processes")


def make_pod_mesh(n_clause: int = 1):
    """The ``(traj, clause)`` :class:`~odesat_tpu_torch.parallel.mesh.Mesh`
    over every rank of the job, called on every rank. A process's ranks are
    consecutive global ranks and the mesh places rank ``r`` at ``(r // S,
    r % S)``, so each clause group lies inside one process when ``S``
    divides the process's rank count ``L``; otherwise it raises ValueError
    (a clause group would span processes, and B7's slots cannot cross a
    host)."""
    from odesat_tpu_torch.parallel.mesh import Mesh

    world = dist.get_world_size()
    check_clause_groups(_local_world_size or world, n_clause)
    return Mesh(world // n_clause, n_clause)
