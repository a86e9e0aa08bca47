"""Multi-process launch: the process-deployment layer (port of
``psk_soft_tpu/parallel/launch.py:1-64``).

The reference deploys as a CORBA executable per host, brokered by the
REDHAWK domain manager (cpp/main.cpp:24-29).  Here every process runs the
same program, ``torch.distributed`` forms the process group over TCP, and
:func:`global_mesh` lays every process's devices out as one mesh; the data
plane is the mesh collectives (parallel/mesh.py).

Typical use, one process per GPU:

    from psk_soft_tpu_torch.parallel import launch
    launch.initialize()                      # PSK_COORDINATOR etc.
    mesh = launch.global_mesh(time=launch.num_hosts())
    run = make_sharded_demod(cfg, mesh, total_symbols)

Lay the *time* axis across processes only when streams are long enough
that the seam halo (numAvg*sps samples) amortizes over the interconnect;
the channel axis is communication-free and is the default process axis.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .mesh import Mesh, local_devices


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` with env fallbacks
    (``PSK_COORDINATOR`` host:port, ``PSK_NUM_PROCESSES``,
    ``PSK_PROCESS_ID``); a no-op for a single process with no coordinator.

    ``backend``: "nccl" or "gloo"; default NCCL when CUDA is available,
    else gloo.  Under NCCL each process takes CUDA device
    ``process_id % device_count`` as its own."""
    coordinator_address = coordinator_address or os.environ.get(
        "PSK_COORDINATOR")
    if num_processes is None and "PSK_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PSK_NUM_PROCESSES"])
    if process_id is None and "PSK_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PSK_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return  # single process
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a process group needs the coordinator address, "
                         "the number of processes and this process's id "
                         "(PSK_COORDINATOR, PSK_NUM_PROCESSES, "
                         "PSK_PROCESS_ID)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    torch.distributed.init_process_group(backend, init_method=init,
                                         world_size=num_processes,
                                         rank=process_id)


def num_hosts() -> int:
    """Processes in the group (1 without one)."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(chan: Optional[int] = None, time: int = 1,
                devices=None) -> Mesh:
    """A (chan, time) mesh over every process's devices, in process order
    (each process's shards its own).  ``devices``: this process's
    devices (default: its CUDA devices; ``["cpu"]`` for a CPU process).
    Every process of the group calls it.

    Defaults to all devices on the channel axis (communication-free).
    """
    local = [torch.device(d) for d in (
        local_devices() if devices is None else devices)]
    dist = torch.distributed
    if dist.is_initialized() and dist.get_world_size() > 1:
        lists: list = [None] * dist.get_world_size()
        dist.all_gather_object(lists, [str(d) for d in local])
    else:
        lists = [[str(d) for d in local]]
    every = [d for lst in lists for d in lst]
    ranks = [r for r, lst in enumerate(lists) for _ in lst]
    n = len(every)
    if chan is None:
        if n % time:
            raise ValueError(f"{n} devices not divisible by time={time}")
        chan = n // time
    if chan * time > n:
        raise ValueError(f"mesh {chan}x{time} needs {chan * time} devices, "
                         f"have {n}")
    grid = np.empty(chan * time, dtype=object)
    for i, d in enumerate(every[:chan * time]):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(chan, time),
                np.asarray(ranks[:chan * time]).reshape(chan, time))
