"""Multi-host start, ported from the JAX package's
``repro.launch.multihost``.

Every process of a multi-host job runs the same program and calls
``initialize()`` first. The coordinator and the process count come from the
arguments or from the standard environment variables
``COORDINATOR_ADDRESS`` (``host:port`` of process 0), ``NUM_PROCESSES`` and
``PROCESS_ID``; the process then joins a ``torch.distributed`` group over
TCP at that address, with ``launch.mesh.pick_backend``'s backend (``nccl``
on the card, ``gloo`` on the CPU) and its card ``cuda:{PROCESS_ID % cards}``.
With neither set, the process runs alone and starts no group.

    COORDINATOR_ADDRESS=10.0.0.1:29500 NUM_PROCESSES=2 PROCESS_ID=0 \\
        python job.py   # job.py calls initialize() at start

The reference's no-argument path asks a TPU runtime to discover the pod
and falls back to one process when that fails; torch has no such runtime,
so a process count without a coordinator raises here. The reference's
``assert_production_topology`` (a TPU pod's 256/512 devices) has no
counterpart. The dry run (``launch/dryrun.py``) does not use this module: it
fakes its ranks in one process.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import pick_backend, rank_device


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device=None) -> dict:
    """Join the job's process group (or run alone) on ``device`` (the card
    unless the caller says). Returns ``process_index``, ``process_count``,
    ``local_devices`` (the visible cards, 1 on the CPU) and
    ``global_devices`` (every process's ``local_devices`` summed)."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("PROCESS_ID")
    dev = resolve_device(device)
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    if coordinator is None and num_processes is None:
        return {"process_index": 0, "process_count": 1, "local_devices": local,
                "global_devices": local}
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-host start needs COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID "
            f"(got coordinator={coordinator!r}, num_processes={num_processes!r}, "
            f"process_id={process_id!r})"
        )
    backend = pick_backend(dev, None, 1)  # this process is one rank
    if dev.type == "cuda":
        dev = rank_device("cuda", process_id)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    total = torch.tensor([local], device=dev)
    dist.all_reduce(total)
    return {"process_index": dist.get_rank(), "process_count": dist.get_world_size(),
            "local_devices": local, "global_devices": int(total.item())}


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v is not None else None
