"""Plain PyTorch version of the residual kernel: the product, the
subtraction and the sums as separate passes over the (J, p[, k]) residual.
It is also the port's residual wherever the kernel does not run:
``core.consensus.block_residual_sq`` calls it."""
from __future__ import annotations

import torch


def match_rhs(bvecs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast unbatched (J, p) bvecs against batched (…, k) state."""
    if x.ndim > bvecs.ndim - 1:
        return bvecs[..., None]
    return bvecs


def residual_sq_ref(blocks: torch.Tensor, bvecs: torch.Tensor, xbar: torch.Tensor,
                    per_block: bool = False):
    """‖A x̄ − b‖² block-wise: a scalar for x̄ (n,), a (k,) vector for x̄
    (n, k), an unbatched b (J, p) broadcast over its columns; with
    ``per_block`` the pair (that, the per-block sums (J[, k]))."""
    r = blocks @ xbar - match_rhs(bvecs, xbar)  # (J, p) or (J, p, k)
    if not per_block:
        return torch.sum(r * r, dim=(0, 1))
    block = torch.sum(r * r, dim=1)
    return torch.sum(block, dim=0), block
