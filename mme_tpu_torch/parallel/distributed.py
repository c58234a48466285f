"""The multi-process runtime: ``torch.distributed`` from the env contract.

Port of ``mme_tpu/parallel/distributed.py``. JAX's mesh is a grid of
devices inside one program; the port's is a grid of ranks, one process per
device, joined by ``torch.distributed``. Every CLI calls
:func:`maybe_initialize` from ``config_from_args``. Explicit arguments beat
the environment:

- ``MME_COORDINATOR``   host:port of rank 0 (``tcp://`` rendezvous)
- ``MME_NUM_PROCESSES`` world size
- ``MME_PROCESS_ID``    this process's rank
- ``MME_DIST_BACKEND``  ``nccl`` or ``gloo``; by default ``nccl`` for a
  ``cuda`` device and ``gloo`` for the CPU

With neither a coordinator nor a process count it is a no-op that returns
False: a single-process run never touches ``torch.distributed``.

A rank's device is ``cuda:{LOCAL_RANK or process_id % device_count}``.
NCCL refuses two ranks on one card, so ranks that share a card (two ranks
on a one-card machine) ask for ``gloo`` explicitly; nothing here picks a
backend by catching a failure.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from mme_tpu_torch.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_writer() -> bool:
    """True on the rank that writes checkpoints, logs and dumps (rank 0)."""
    return rank() == 0


def rank_device(device: DeviceLike, process_id: Optional[int] = None
                ) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK or process_id %
    device_count}`` for ``cuda``; any other device as it is."""
    dev = torch.device(device)
    local = os.environ.get("LOCAL_RANK")
    if dev.type != "cuda" or dev.index is not None or (
            process_id is None and not local and not is_initialized()):
        return dev          # one process: the current card
    pid = rank() if process_id is None else process_id
    index = int(local) if local else pid % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", index)


def default_backend(device: DeviceLike) -> str:
    """``MME_DIST_BACKEND`` if set, else ``nccl`` for ``cuda`` and ``gloo``
    for the CPU."""
    env = os.environ.get("MME_DIST_BACKEND")
    if env:
        if env not in BACKENDS:
            raise ValueError(f"MME_DIST_BACKEND={env!r} is not one of "
                             f"{BACKENDS}")
        return env
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: DeviceLike = "cuda",
                     timeout_s: float = 600.0) -> bool:
    """Join the process group when the env contract (or the arguments) ask
    for one; False, and nothing done, otherwise. A second call after a
    successful one returns True at once. ``device`` sets the default
    backend and is where this rank's CUDA device is made current."""
    if is_initialized():
        return True
    coordinator = coordinator or os.environ.get("MME_COORDINATOR") or None
    if num_processes is None and os.environ.get("MME_NUM_PROCESSES"):
        num_processes = int(os.environ["MME_NUM_PROCESSES"])
    if process_id is None and os.environ.get("MME_PROCESS_ID"):
        process_id = int(os.environ["MME_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator (MME_COORDINATOR), "
            "the process count (MME_NUM_PROCESSES) and this process's id "
            f"(MME_PROCESS_ID); got {coordinator!r}, {num_processes!r}, "
            f"{process_id!r}")
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    dev = rank_device(resolve_device(device), process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    print(f"distributed runtime: rank {dist.get_rank()}/"
          f"{dist.get_world_size()}, backend {backend}, device {dev}",
          flush=True)
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if is_initialized():
        dist.destroy_process_group()
