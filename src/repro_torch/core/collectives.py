"""The collectives of the multi-device solvers, behind one small wrapper.

Every all-reduce and all-gather the sharded solvers make goes through a
``Collectives`` object bound to one process group (a mesh axis, or several
flattened). While a ``recording()`` is armed, each call appends ``(epoch,
op, numel)`` — ``epoch`` is the epoch the solver's loop was in (``None``
outside it), ``numel`` the elements the call returns — which is what
``repro_torch.obs.audit_epoch_collectives`` counts. The counts come from the
calls made, never from a constant.

``all_gather`` is one zero-padded ``all_reduce(SUM)``: each rank writes its
piece into its own slot of a zero tensor, so the sum is exact (x + 0 = x)
on any backend, gloo's CUDA tensors included.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass
class Recorder:
    """The calls made while armed: ``(epoch, op, numel)`` triples."""

    calls: list = field(default_factory=list)


class Collectives:
    """All-reduce / all-gather over ``group`` (``size`` ranks; this rank is
    shard ``index`` of them), recorded while a ``Recorder`` is armed."""

    def __init__(self, group, size: int, index: int):
        self.group = group
        self.size = int(size)
        self.index = int(index)
        self._recorder: Recorder | None = None
        self._epoch: int | None = None

    def mark_epoch(self, epoch: int | None) -> None:
        """The solver's loop is now in ``epoch`` (``None``: outside it)."""
        self._epoch = epoch

    @contextlib.contextmanager
    def recording(self):
        """Arm a fresh ``Recorder`` for the calls made inside the block."""
        rec = Recorder()
        self._recorder = rec
        try:
            yield rec
        finally:
            self._recorder = None
            self._epoch = None

    def _record(self, op: str, numel: int) -> None:
        if self._recorder is not None:
            self._recorder.calls.append((self._epoch, op, int(numel)))

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over the group IN PLACE and return it."""
        self._record(f"all_reduce_{op}", t.numel())
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The group mean of ``t`` (reduced in place): one SUM, then /size."""
        return self.all_reduce(t) / self.size

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in shard order."""
        shape = list(t.shape)
        piece = shape[dim]
        shape[dim] = piece * self.size
        out = torch.zeros(shape, dtype=t.dtype, device=t.device)
        out.narrow(dim, self.index * piece, piece).copy_(t)
        self._record("all_gather", out.numel())
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out


def mesh_axes_group(mesh, axes: tuple[str, ...]) -> Collectives:
    """``Collectives`` over the mesh axes ``axes``: this rank's shard index
    is its row-major coordinate along them.

    One axis uses that axis's group; all the mesh's axes use the group of
    every rank of the mesh (it must be the whole process group).
    """
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(
            f"block_axes {tuple(axes)} not in mesh axes {names}: missing {missing}"
        )
    coord = mesh.get_coordinate()
    sizes = [mesh.size(names.index(a)) for a in axes]
    index = 0
    for a, extent in zip(axes, sizes):
        index = index * extent + coord[names.index(a)]
    size = math.prod(sizes)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    elif sorted(axes) == sorted(names) and mesh.mesh.numel() == dist.get_world_size():
        group = dist.group.WORLD
    else:
        raise ValueError(
            f"block_axes {tuple(axes)}: the port shards over one mesh axis "
            f"or over all of {names}"
        )
    return Collectives(group, size, index)
