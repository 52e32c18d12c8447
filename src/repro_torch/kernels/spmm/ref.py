"""Plain PyTorch versions of the blocked-ELL SpMM kernels, plus densifying
oracles for the tests.

``spmm_plain`` and ``spmm_fused_plain`` have the ELL interfaces and outputs
(gather + einsum, in the data dtype); the CPU path of the wrappers and the
matrix-free solver's ``use_kernels=False`` products run them.
``spmm_packed_plain`` is the packed kernel's plain version (a segment sum over
the packed entries), which ``spmm_packed`` takes on a CPU tensor, and
``spmm_fused_packed_plain`` the fused packed kernel's: the same on the forward
and the transposed packed forms.
``blocked_ell_to_dense``, ``spmm_ref`` and ``spmm_fused_ref`` copy the JAX
package's oracles (``repro/kernels/spmm/ref.py``): they densify every shard
and multiply in float32, exactly what the matrix-free path exists to avoid.
"""
from __future__ import annotations

import torch


def _gather_tiles(indices: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x[j, indices[j, r, s]] for every slot: (J, R, S, bn, k)."""
    jj = torch.arange(indices.shape[0], device=indices.device)[:, None, None]
    return x[jj, indices.long()]


def spmm_plain(
    indices: torch.Tensor,  # (J, R, S) int32
    data: torch.Tensor,  # (J, R, S, bp, bn)
    x: torch.Tensor,  # (J, C, bn, k)
) -> torch.Tensor:
    """Σ_s data[j, r, s] @ x[j, indices[j, r, s]] as (J, R*bp, k)."""
    out = torch.einsum("jrspb,jrsbk->jrpk", data, _gather_tiles(indices, x))
    return out.reshape(data.shape[0], -1, x.shape[-1])


def spmm_packed_plain(packed, x: torch.Tensor) -> torch.Tensor:
    """The product of a ``pack.Packed`` operator with x (J, C, bn, k):
    Σ val·x[j, col] per row, as (J, block_rows, k) in the data dtype."""
    J, k = packed.num_blocks, x.shape[-1]
    rows = J * packed.block_rows
    counts = (packed.row_ptr[1:] - packed.row_ptr[:-1]).long()
    row = torch.repeat_interleave(torch.arange(rows, device=x.device), counts)
    xf = x.reshape(J, -1, k)
    terms = packed.val[:, None] * xf[row // packed.block_rows, packed.col.long()]
    out = torch.zeros((rows, k), dtype=packed.val.dtype, device=x.device)
    out.index_add_(0, row, terms)
    return out.reshape(J, packed.block_rows, k)


def spmm_fused_packed_plain(
    fwd_packed, tra_packed, xb: torch.Tensor, yb: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(A_j x (J, Rp*bp, k), A_jᵀ y_j (J, Rn*bn, k)): the products of the
    forward packed form with x (J, C, bn, k) and of the transposed packed form
    with y (J, Rp, bp, k)."""
    return spmm_packed_plain(fwd_packed, xb), spmm_packed_plain(tra_packed, yb)


def spmm_fused_plain(
    indices: torch.Tensor,  # (J, R, S) int32
    data: torch.Tensor,  # (J, R, S, bp, bn)
    x: torch.Tensor,  # (J, C, bn, k)
    y: torch.Tensor,  # (J, R, bp, k)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(forward (J, R*bp, k), staged contrib (J, R, S, bn, k)) where
    ``contrib[j, r, s] = data[j, r, s]ᵀ @ y[j, r]``."""
    contrib = torch.einsum("jrspb,jrpk->jrsbk", data, y)
    return spmm_plain(indices, data, x), contrib


def blocked_ell_to_dense(
    indices: torch.Tensor,  # (R, S) int32
    data: torch.Tensor,  # (R, S, bp, bn)
    num_col_blocks: int,
) -> torch.Tensor:
    """One shard densified to (R*bp, num_col_blocks*bn) float32."""
    R, S = indices.shape
    bp, bn = data.shape[-2:]
    out = torch.zeros((R * num_col_blocks, bp, bn), dtype=torch.float32, device=data.device)
    rows = torch.arange(R, device=data.device).repeat_interleave(S) * num_col_blocks
    # padding slots (id 0, zero data) add exactly 0 — scatter-add is safe
    out.index_add_(0, rows + indices.reshape(-1).long(), data.reshape(R * S, bp, bn).float())
    out = out.reshape(R, num_col_blocks, bp, bn)
    return out.permute(0, 2, 1, 3).reshape(R * bp, num_col_blocks * bn)


def spmm_ref(indices, data, x) -> torch.Tensor:
    """Dense reference of ``spmm``: (J, R*bp, k) float32."""
    C, k = x.shape[1], x.shape[-1]
    return torch.stack([
        blocked_ell_to_dense(indices[j], data[j], C) @ x[j].reshape(-1, k).float()
        for j in range(indices.shape[0])
    ])


def spmm_fused_ref(indices, data, x, y) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense reference of the fused pass: (A x (J, R*bp, k), Aᵀ y
    (J, C*bn, k)), both float32 — the transpose fully scatter-added (the
    kernel's staged per-slot form is compared after the scatter)."""
    C, k = x.shape[1], x.shape[-1]
    fwd, tra = [], []
    for j in range(indices.shape[0]):
        dense = blocked_ell_to_dense(indices[j], data[j], C)
        fwd.append(dense @ x[j].reshape(-1, k).float())
        tra.append(dense.T @ y[j].reshape(-1, k).float())
    return torch.stack(fwd), torch.stack(tra)
