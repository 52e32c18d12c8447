"""Sharded matrix-free solver: blocked-ELL shards on the ranks of a mesh.

The matrix-free path (``repro_torch.core.matfree``) fits sparse systems that
would never densify, on one device. Here the ``PartitionedBSR`` is built in
host memory and each rank of a ``torch.distributed`` mesh keeps one
contiguous group of J/D partition blocks on its device
(``PartitionedBSR.place``); every rank runs the same fused-projection epoch
over its own blocks — the JAX package's ``shard_map`` program as an SPMD
program of D processes.

Communication per epoch, every call through one ``Collectives`` wrapper
(``repro_torch.core.collectives``), which the collective audit reads:

  * exactly ONE n·k ``all_reduce(SUM)`` — the consensus average of eq. 5/7,
    the local block mean summed over the ranks and divided by D. Without
    ``tol`` the k-length residual is reporting only: each rank keeps its
    (E, k) partial sums and one all-reduce after the loop collapses them;
  * ``solve(..., tol=...)`` adds the k-length residual all-reduce back into
    the epoch: the freeze predicate must agree on every rank;
  * both inner Gram solvers are rank-local. ``"direct"`` applies the local
    pseudo-inverses; ``"pcg"`` iterates on the local Gram shards with a
    rank-local stopping test (its host read may stop at a different depth
    on each rank) and adds one k-length ``all_reduce(MAX)`` per epoch for
    ``history["inner_iters"]``;
  * ``block_history=True`` adds one all-gather after the loop, none in it.

``prepare(A, mode="matfree", mesh=...)`` builds one of these on every rank;
the solve contract is ``MatrixFreePreparedSolver``'s, and every rank
returns the same replicated ``SolveResult``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.collectives import Collectives, mesh_axes_group
from repro_torch.core.matfree import MatrixFreePreparedSolver, _identity
from repro_torch.device import resolve_device
from repro_torch.sparse.bsr import _ARRAY_FIELDS, PartitionedBSR


def mesh_block_devices(mesh, block_axes) -> int:
    """Number of shards the block axis is split over (product of the mesh
    extents of ``block_axes``); raises for axes the mesh does not have."""
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in block_axes if a not in names]
    if missing:
        raise ValueError(
            f"block_axes {tuple(block_axes)} not in mesh axes {names}: "
            f"missing {missing}"
        )
    return math.prod(mesh.size(names.index(a)) for a in block_axes)


def mesh_device(mesh, device=None) -> torch.device:
    """The device this rank computes on for ``mesh``: the current card of a
    CUDA mesh, or the CPU. ``device``, when given, must be of the mesh's
    type (an explicit CUDA index wins)."""
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    if device is not None:
        want = resolve_device(device)
        if want.type != dev.type:
            raise ValueError(
                f"device={str(want)!r} but the mesh is on {mesh.device_type!r}"
            )
        if want.index is not None:
            dev = want
    return dev


@dataclasses.dataclass
class ShardedMatrixFreeSolver(MatrixFreePreparedSolver):
    """``MatrixFreePreparedSolver`` whose blocks are sharded over ``mesh``:
    ``op`` holds this rank's J/D blocks, and an epoch's collectives are the
    n·k consensus all-reduce plus — only under ``tol`` — the k-length
    residual all-reduce (see module docstring).

    Every rank of the mesh must make the same calls in the same order
    (prepare, solve, ``to_state``): each may enter a collective.
    ``memory_bytes`` reports the GLOBAL operator bytes (the sum over the
    ranks), ``per_device_memory_bytes`` the most one rank holds; both are
    read once, at construction.
    """

    mesh: object = None  # torch.distributed.device_mesh.DeviceMesh
    block_axes: tuple[str, ...] = ("data",)
    comm: Collectives = dataclasses.field(init=False, repr=False, default=None)

    path = "matfree_sharded"

    def __post_init__(self):
        self.block_axes = tuple(self.block_axes)
        self.comm = mesh_axes_group(self.mesh, self.block_axes)
        local = torch.tensor([self.local_memory_bytes], dtype=torch.int64, device=self.device)
        self._memory_total = int(self.comm.all_reduce(local.clone()).item())
        self._memory_worst = int(self.comm.all_reduce(local.clone(), "max").item())

    @property
    def num_shards(self) -> int:
        return self.comm.size

    @property
    def num_blocks(self) -> int:
        return self.op.global_blocks

    @property
    def local_memory_bytes(self) -> int:
        """Resident operator bytes on this rank's device."""
        return super().memory_bytes

    @property
    def memory_bytes(self) -> int:
        """Resident operator bytes summed over the ranks."""
        return self._memory_total

    @property
    def per_device_memory_bytes(self) -> int:
        """The most any one rank holds (ELL tiles, packed forms, Gram
        inverse, Jacobi weights), measured on each rank's placed tensors."""
        return self._memory_worst

    def _dynamics_operands(self, gamma, eta, per_block: bool):
        """Per-block γ and η vectors are sliced to this rank's blocks; η̄
        stays the global mean (replicated, no collective)."""
        gamma_op, eta_op = super()._dynamics_operands(gamma, eta, per_block)
        if not per_block:
            return gamma_op, eta_op
        lo, hi = self.op.shard[:2]
        return gamma_op[lo:hi], (eta_op[0][lo:hi], eta_op[1])

    def _epochs(self, bvecs, gamma_op, eta_op, ref, warm, *, tol, num_epochs,
                inner_iters, block_history):
        comm = self.comm
        partial = tol is None  # residuals are reporting only: collapse later
        x, hist = super()._epochs(
            bvecs, gamma_op, eta_op, ref, warm, tol=tol, num_epochs=num_epochs,
            inner_iters=inner_iters, block_history=block_history,
            # mean over the LOCAL blocks, then one n·k all-reduce over the mesh
            block_mean=lambda a: comm.mean(torch.mean(a, dim=0)),
            reduce_sum=_identity if partial else comm.all_reduce,
            iters_reduce=lambda c: comm.all_reduce(c, "max"),
            mark_epoch=comm.mark_epoch,
        )
        initial = hist["initial"]
        if partial:  # ONE all-reduce for every epoch's partial sums
            stacked = comm.all_reduce(
                torch.cat([initial["residual_sq"][None], hist["residual_sq"]])
            )
            initial["residual_sq"], hist["residual_sq"] = stacked[0], stacked[1:]
        if block_history:  # each rank's (E, J_loc, k) rows, in block order
            rows = comm.all_gather(
                torch.cat([initial["block_residual_sq"][None], hist["block_residual_sq"]]),
                dim=1,
            )
            initial["block_residual_sq"], hist["block_residual_sq"] = rows[0], rows[1:]
        return x, hist

    # -- checkpoint serialization -------------------------------------------

    def to_state(self) -> tuple[dict, dict]:
        """The whole operator's state (``MatrixFreePreparedSolver`` format):
        each per-block array is gathered from every rank — a collective, so
        every rank calls it. Mesh placement is not part of the state."""
        gathered = {
            name: self.comm.all_gather(getattr(self.op, name))
            for name in _ARRAY_FIELDS
            if getattr(self.op, name) is not None
        }
        whole = dataclasses.replace(
            self.op, **gathered, fwd_packed=None, tra_packed=None,
            gram_packed=None, shard=None,
        )
        solver = MatrixFreePreparedSolver(**{
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(MatrixFreePreparedSolver)
        })
        solver.op = whole
        solver.diag_inv = self.comm.all_gather(self.diag_inv)
        if self.gram_inv is not None:
            solver.gram_inv = self.comm.all_gather(self.gram_inv)
        return solver.to_state()

    @classmethod
    def from_state(cls, arrays, meta: dict, device=None, mesh=None,
                   block_axes: tuple[str, ...] = ("data",)):
        """Restore ``to_state`` output (this package's or the JAX package's)
        onto ``mesh`` with the placement ``prepare`` uses: the operator is
        rebuilt in host memory and each rank keeps its own blocks."""
        if mesh is None:
            raise ValueError("a sharded solver restores onto a mesh: pass mesh=")
        block_axes = tuple(block_axes)
        dev = mesh_device(mesh, device)
        host = PartitionedBSR.from_arrays(arrays, meta["op"], device="cpu")
        op = host.place(mesh, block_axes, device=dev).for_kernels(meta["use_kernels"])
        lo, hi = op.shard[:2]
        return cls._restore(op, arrays, meta, dev, blocks=slice(lo, hi),
                            mesh=mesh, block_axes=block_axes)
