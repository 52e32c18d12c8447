"""Distributed Gradient Descent baseline (paper Fig. 2 comparison, ref. [5]).

Synchronous DGD on the global least-squares objective: each worker holds a
row block, computes its local gradient A_jᵀ(A_j x_j − b_j), and mixes
estimates by uniform consensus averaging (the paper's star/scheduler
topology = complete mixing matrix).

Multi-RHS: bvecs (J, p, k) runs the k descents in one batch; the step size
depends only on λ_max(AᵀA), so it is shared across columns (and is the
cacheable setup of the prepare/solve API). The reference's ``lax.scan``
becomes a Python loop over preallocated ``(E, …)`` histories, with no host
read per epoch.
"""
from __future__ import annotations

import torch

from repro_torch.core.cg import baseline_metrics, block_matvec, empty_history
from repro_torch.core.partition import Partition


def power_iteration(blocks: torch.Tensor, v: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """λ_max(AᵀA) by ``iters`` power steps on the stacked blocks from the
    start vector ``v`` (n,); returns the last norm estimate as a 0-d tensor."""
    v = v / torch.linalg.vector_norm(v)
    blocks_t = blocks.mT
    for _ in range(iters):
        w = blocks @ v  # (J, p)
        v = block_matvec(blocks_t, w).sum(dim=0)  # Σ_j A_jᵀ w_j
        lam = torch.linalg.vector_norm(v)
        v = v / lam
    return lam


def estimate_lipschitz(blocks: torch.Tensor, iters: int = 30, seed: int = 0) -> torch.Tensor:
    """λ_max(AᵀA) via power iteration (sets the DGD step).

    The start vector is drawn on the host from a ``torch.Generator`` seeded
    with ``seed``, so the card and the CPU start from the same vector. The
    reference draws it with ``jax.random``, whose bits torch cannot draw:
    the two agree on λ_max to the iteration's convergence, not bit for bit.
    """
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(blocks.shape[-1], generator=gen, dtype=blocks.dtype)
    return power_iteration(blocks, v.to(blocks.device), iters)


def solve_dgd(
    part: Partition,
    lr: float | None = None,
    num_epochs: int = 100,
    x_ref: torch.Tensor | None = None,
):
    """DGD end to end. Returns (x̄, history dict matching APC's).

    ``part.bvecs`` may carry a trailing (J, p, k) batch axis."""
    blocks, bvecs = part.blocks, part.bvecs
    num_blocks, _, n = blocks.shape
    if lr is None:
        lr = 1.0 / estimate_lipschitz(blocks)  # per-worker gradients; safe sync-DGD step
    shape = (num_blocks, n, bvecs.shape[-1]) if bvecs.ndim == 3 else (num_blocks, n)
    xs = torch.zeros(shape, dtype=blocks.dtype, device=blocks.device)
    blocks_t = blocks.mT
    initial = baseline_metrics(blocks, bvecs, x_ref, torch.mean(xs, dim=0))
    hist = empty_history(initial, num_epochs)
    for t in range(num_epochs):
        xbar = torch.mean(xs, dim=0)  # complete mixing
        grads = block_matvec(blocks_t, block_matvec(blocks, xs) - bvecs)
        xs = xbar[None] - lr * grads
        for key, v in baseline_metrics(blocks, bvecs, x_ref, torch.mean(xs, dim=0)).items():
            hist[key][t] = v
    hist["initial"] = initial
    return torch.mean(xs, dim=0), hist
