"""The packed-nonzero form of a blocked-ELL shard stack, which the
``spmm_packed`` kernel streams.

``pack(indices, data)`` keeps only the nonzeros of the (J, R, S, bp, bn)
tiles, as a CSR over the J·R·bp output rows: rows in (j, r, p) order and each
row's entries in (slot s, tile column b) order, the order in which the ELL
product adds them. ``col`` names the row of x's flattened padded column space
(``indices·bn + b``), so a product gathers one x row per nonzero. It runs once
per operator (``PartitionedBSR.with_packed``), as plain torch ops on the
operator's device; explicit zeros, padding slots and empty tiles are dropped,
which is exact.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Packed:
    """CSR of the nonzeros of (J, R, S, bp, bn) blocked-ELL shards."""

    row_ptr: torch.Tensor  # (J*R*bp + 1,) int32
    col: torch.Tensor  # (nnz,) int32: x row idx*bn + b
    val: torch.Tensor  # (nnz,) in the data dtype
    num_blocks: int  # J
    block_rows: int  # R*bp output rows per block
    bn: int  # tile width: x is the (J, C, bn, k) tile view

    @property
    def nnz(self) -> int:
        return self.col.numel()

    @property
    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in (self.row_ptr, self.col, self.val)))


def pack(indices: torch.Tensor, data: torch.Tensor) -> Packed:
    """indices (J, R, S) int32, data (J, R, S, bp, bn) -> ``Packed`` on the
    same device."""
    J, R, S, bp, bn = data.shape
    rows = J * R * bp
    tiles = data.permute(0, 1, 3, 2, 4)  # (J, R, bp, S, bn): a row's entries in (s, b) order
    live = tiles != 0
    row_ptr = torch.zeros(rows + 1, dtype=torch.int64, device=data.device)
    row_ptr[1:] = torch.cumsum(live.reshape(rows, S * bn).sum(dim=1), 0)
    if rows and int(row_ptr[-1]) >= 2**31:
        raise ValueError(f"pack: {int(row_ptr[-1])} nonzeros do not fit int32 offsets")
    j, r, p, s, b = live.nonzero(as_tuple=True)  # row-major: (row, s, b) order
    col = indices[j, r, s].long() * bn + b
    return Packed(
        row_ptr.to(torch.int32), col.to(torch.int32), tiles[j, r, p, s, b].contiguous(),
        J, R * bp, bn,
    )
