"""Projection operators onto ``null(A_j)`` — classical vs decomposed forms.

Unified representation: a factor ``W ∈ R^{p×n}`` such that ``P = I_n − WᵀW``.

  * tall blocks (p >= n): ``A_j = Q1_j R_j`` (reduced QR), ``W = Q1_j``
    — exactly the paper's eq. (4) ``P_j = I_n − Q1ᵀQ1``.
  * wide blocks (p < n): ``A_jᵀ = Q_j R_j`` (reduced QR), ``W = Q_jᵀ``
    — ``P_j = I_n − Q Qᵀ``, the same decomposition idea in the regime where
    the nullspace is non-trivial.

``apply_projection`` is the implicit application ``P v = v − Wᵀ(W v)``
(never materializes the n×n ``P``); ``materialize`` builds the dense ``P``.

Every function takes one block or a leading batch of blocks (torch's
linear algebra batches over leading axes where the reference used vmap).
Factors come back contiguous: the hand kernels read them by raw pointer.
"""
from __future__ import annotations

import torch


def qr_factor(block: torch.Tensor, mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR per paper eq. (1). Returns (W, R), both contiguous.

    tall: block (p,n) -> Q1 (p,n), R (n,n), W = Q1.
    wide: blockᵀ (n,p) -> Q (n,p), R (p,p), W = Qᵀ (p,n).
    """
    if mode == "tall":
        q, r = torch.linalg.qr(block, mode="reduced")
        return q.contiguous(), r.contiguous()
    q, r = torch.linalg.qr(block.mT, mode="reduced")
    return q.mT.contiguous(), r.contiguous()


def batched_mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M_j v_j for M (J, a, b) and v (J, b) or (J, b, k) — the reference's
    "jab,jb...->ja..." einsum."""
    if v.ndim == M.ndim - 1:
        return (M @ v[..., None])[..., 0]
    return M @ v


def apply_projection(W: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Implicit ``(I − WᵀW) v`` — two tall-skinny matmuls, no n×n temp.
    ``v`` is ``(n,)`` or ``(n, k)``; a batched ``W`` (..., p, n) takes a
    matching batch of ``v``, as the reference's ``.mT`` does."""
    return v - W.mT @ (W @ v)


def pinv(block: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.pinv``: singular values below ``10·max(p, n)·eps`` times
    the largest count as zero (torch's default cutoff is 10x smaller, which
    keeps noise directions of a near-singular block)."""
    rtol = 10.0 * max(block.shape[-2:]) * torch.finfo(block.dtype).eps
    return torch.linalg.pinv(block, rtol=rtol)


def materialize(W: torch.Tensor) -> torch.Tensor:
    """Dense ``P = I − WᵀW`` (paper-faithful; O(n²) memory)."""
    n = W.shape[-1]
    return torch.eye(n, dtype=W.dtype, device=W.device) - W.mT @ W


def classical_projection(block: torch.Tensor, mode: str) -> torch.Tensor:
    """Inverse-based classical-APC projector (test oracle / baseline).

    wide: P = I − Aᵀ(AAᵀ)⁻¹A. tall: P = I − A⁺A (≈ 0 for full column rank).
    """
    n = block.shape[-1]
    eye = torch.eye(n, dtype=block.dtype, device=block.device)
    if mode == "wide":
        gram = block @ block.mT
        return eye - block.mT @ torch.linalg.solve(gram, block)
    return eye - pinv(block) @ block


def classical_initial(block: torch.Tensor, bvec: torch.Tensor, mode: str) -> torch.Tensor:
    """Classical init via pseudoinverse (SVD — the cost the paper removes).

    wide: min-norm solution Aᵀ(AAᵀ)⁻¹b; tall: least-squares A⁺b.
    Batched: block (J, p, n), bvec (J, p) or (J, p, k).
    """
    return batched_mv(pinv(block), bvec)
