"""The multi-process runtime (counterpart of ``gqx/parallel/distributed.py``)
on ``torch.distributed``.

A run has W processes (ranks), one device each.  ``maybe_initialize`` opens
the process group: NCCL where the entry point runs on the card (rank r
takes ``cuda:{local rank}``), gloo only where the caller asked for the CPU.
gqx's explicit arguments (coordinator address, process count, process id)
give it its rendezvous; without them, torchrun's environment (``MASTER_ADDR``,
``RANK``, ``WORLD_SIZE``) is the counterpart of gqx's auto mode; with
neither, ``world_of_one`` opens a group of one process in process (a
``HashStore``), as ``--backend mesh`` alone does.

Data feeding is gqx's: every rank computes the same global batch from the
seed and keeps its own users' rows.  Rank r owns the contiguous users
``[r*U/W, (r+1)*U/W)``, as gqx's mesh lays users over its devices.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gqx_torch import resolve_device

#: torchrun's variables: the counterpart of gqx's auto-detected coordinator
TORCHRUN_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def backend_for(device) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda", world_of_one: bool = False) -> bool:
    """Open the default process group if one is asked for; returns True if
    this call opened it (its caller then destroys it).

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or an
    ``init_method`` URL (``file:///path``); it needs ``num_processes`` and
    ``process_id``.  Without it, torchrun's environment opens the group;
    without either, ``world_of_one`` opens a group of one in process, and
    otherwise nothing is opened (a process count above one without a
    coordinator raises).  A group that is already open is left as it is."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = backend_for(dev)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator-address needs --num-processes and --process-id")
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        rank, world = int(process_id), int(num_processes)
        _take_device(dev, rank)
        dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)
    elif all(v in os.environ for v in TORCHRUN_ENV):
        _take_device(dev, int(os.environ["RANK"]))
        dist.init_process_group(backend)
    elif num_processes not in (None, 1) or process_id not in (None, 0):
        raise ValueError(f"{num_processes} processes (process id {process_id}) need "
                         "--coordinator-address")
    elif world_of_one:
        _take_device(dev, 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        return False
    return True


def _take_device(dev: torch.device, rank: int) -> None:
    """A rank on the card takes ``cuda:{local rank}`` (torchrun's
    ``LOCAL_RANK``, else the rank modulo the cards of the host)."""
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) where none is open."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def check_backend(device) -> None:
    """Raise unless the open group's backend is the device's: NCCL moves
    tensors on the card, gloo tensors on the CPU."""
    backend = dist.get_backend()
    want = backend_for(device)
    if backend != want:
        raise ValueError(f"a {backend} process group with tensors on {torch.device(device)}: "
                         f"the distributed backend takes {want} there")


def process_user_range(num_users: int, rank: int, world: int) -> Tuple[int, int]:
    """[start, stop) of the users rank ``rank`` of ``world`` owns.  ``world``
    must divide ``num_users``: gqx drops devices until their count does,
    and a rank cannot be dropped."""
    if num_users % world:
        raise ValueError(f"{world} processes do not divide {num_users} users: the distributed "
                         "backend needs a process count that divides --num-users")
    per = num_users // world
    return rank * per, (rank + 1) * per


def local_user_batch(arr: np.ndarray, rank: int, world: int) -> np.ndarray:
    """The rows of a global (num_users, ...) batch that rank ``rank`` owns
    (the counterpart of gqx's ``global_user_batch``: every rank computes the
    same global batch and keeps its own users)."""
    start, stop = process_user_range(arr.shape[0], rank, world)
    return arr[start:stop]
