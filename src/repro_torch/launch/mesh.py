"""Host-local device meshes and the rank launcher of the multi-device path.

The JAX package runs its multi-device solvers as one program over a
``jax.sharding.Mesh`` of the host's devices. The port runs them as SPMD
programs on ``torch.distributed``: one process per shard (a *rank*), joined
by a process group, with a ``DeviceMesh`` carrying the reference's axis
names — ``("data",)`` for the block-sharded solvers, ``("data", "model")``
for the 2-D solver.

  * ``run_ranks(entry, D, backend, device, args)`` spawns D ranks, each of
    which sets its device, joins the group, calls ``entry(rank, *args)`` and
    leaves the group;
  * ``make_host_local_mesh(D)`` is the 1-D ``("data",)`` mesh over those
    ranks. With ``D = 1`` and no group yet it starts a single-rank group in
    this process, so a one-device mesh needs no launcher;
  * ``make_debug_mesh()`` is the single-rank mesh with the production axis
    names ``("data", "model")``; ``make_mesh(shape, names)`` any other;
  * ``run_commands`` runs several launchers' rank bodies on one spawn.

The backend is chosen once and never switched: ``nccl`` on CUDA, ``gloo`` on
the CPU, or what the caller names. NCCL needs one card per rank, so a
``nccl`` mesh with more ranks than visible cards raises; ``gloo`` runs any
number of ranks on one card, staging each collective through host memory.

The reference's ``make_production_mesh``, ``force_host_device_count`` and
``multihost.assert_production_topology`` describe TPU pods and XLA's host
platform; they have no counterpart on one H100.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

BACKENDS = ("gloo", "nccl")


def pick_backend(device, backend: str | None, ranks: int) -> str:
    """The process-group backend for ``ranks`` ranks on ``device``.

    ``None`` gives ``nccl`` on CUDA and ``gloo`` on the CPU. Raises
    ``ValueError`` for an unknown backend, ``nccl`` off CUDA, and ``nccl``
    with more ranks than visible cards (``backend="gloo"`` shares a card).
    """
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend='nccl' runs on CUDA devices only")
        cards = torch.cuda.device_count()
        if ranks > cards:
            raise ValueError(
                f"backend='nccl' needs one card per rank: {ranks} ranks, "
                f"{cards} visible card(s); pass backend='gloo' to run "
                "several ranks on one card"
            )
    return backend


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device a rank computes on: ``cuda:{rank % cards}``, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device_type)


def _rank_main(rank, entry, ranks, backend, device_type, init_method, threads, args):
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(device_type, rank))
    else:  # ranks on the CPU share the launcher's threads, not oversubscribe
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=ranks
    )
    try:
        entry(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(entry, ranks: int, backend: str | None = None, device=None,
              args: tuple = ()) -> None:
    """Run ``entry(rank, *args)`` on ``ranks`` spawned processes.

    Each rank sets its device (``cuda:{rank % cards}``; CPU ranks split this
    process's intra-op threads between them), joins a process
    group of ``backend`` (``pick_backend``) through a file store in a fresh
    temporary directory, runs ``entry`` and leaves the group. ``entry`` must
    be importable by path (a module-level function of an importable module):
    the ranks start from a fresh interpreter (the spawn start method), so a
    parent that has already initialised CUDA can launch them. Returns when
    every rank has finished; raises if any rank raised.
    """
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    backend = pick_backend(dev, backend, ranks)
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        mp.start_processes(
            _rank_main,
            args=(entry, ranks, backend, dev.type, init_method,
                  max(1, torch.get_num_threads() // ranks), tuple(args)),
            nprocs=ranks,
            join=True,
            start_method="spawn",
        )


def run_commands(rank: int, commands) -> None:
    """A ``run_ranks`` entry that runs several launchers on one set of ranks:
    ``commands`` lists ``(module, argv)`` pairs, and each module's
    ``rank_main(rank, argv)`` runs in turn (``repro_torch.launch.solve``,
    ``.sharded_solve``), so one spawn serves them all."""
    import importlib

    for module, argv in commands:
        importlib.import_module(module).rank_main(rank, list(argv))
        dist.barrier()


def _ensure_group(ranks: int, device: torch.device, backend: str | None) -> None:
    """Start a single-rank group in this process when none exists (``ranks
    = 1``); otherwise the group must already span exactly ``ranks``."""
    if dist.is_initialized():
        if dist.get_world_size() != ranks:
            raise ValueError(
                f"the process group has {dist.get_world_size()} ranks, the "
                f"mesh asks for {ranks}"
            )
        return
    if ranks != 1:
        raise ValueError(
            f"a {ranks}-rank mesh needs {ranks} processes: start them with "
            "run_ranks"
        )
    backend = pick_backend(device, backend, 1)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device, backend):
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    ranks = 1
    for extent in shape:
        ranks *= extent
    _ensure_group(ranks, dev, backend)
    return DeviceMesh(
        dev.type, torch.arange(ranks).reshape(shape), mesh_dim_names=names
    )


def make_host_local_mesh(devices: int, *, device=None, backend: str | None = None):
    """``(devices,)``-shaped ``("data",)`` mesh: the block-sharded layout the
    sharded matrix-free path places its ELL shards over. ``device=None`` is
    the card."""
    return _mesh((devices,), ("data",), device, backend)


def make_debug_mesh(*, device=None, backend: str | None = None):
    """Single-rank mesh with the production axis names ``("data",
    "model")``."""
    return _mesh((1, 1), ("data", "model"), device, backend)


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], *, device=None,
              backend: str | None = None):
    """A mesh of any shape over the ranks of the current group (row-major
    rank order), e.g. ``make_mesh((2, 2), ("data", "model"))``."""
    if len(shape) != len(names):
        raise ValueError(f"shape {shape} and names {names} differ in length")
    return _mesh(tuple(shape), tuple(names), device, backend)
