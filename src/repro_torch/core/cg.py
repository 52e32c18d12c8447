"""CGNR baseline: conjugate gradient on the normal equations AᵀA x = Aᵀb.

CG-type Krylov methods are the standard distributed alternative for
consistent least-squares systems. Per iteration each block computes
A_jᵀ(A_j p) on its rows, followed by one n-vector sum over blocks. There is
no setup phase, but κ(AᵀA) = κ(A)², so ill-conditioned systems need far
more epochs than the APC family.

Multi-RHS: with bvecs (J, p, k) every reduction (α, β, ‖r‖²) is taken per
column, so the k Krylov iterations proceed independently in one batch. The
reference's ``lax.scan`` becomes a Python loop that only queues device work
and writes each epoch's metrics into preallocated ``(E, …)`` tensors. The
block products are plain batched matmuls (the reference's einsums).
"""
from __future__ import annotations

import torch

from repro_torch.core.partition import Partition


def block_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-block product: (J, r, c) × (J, c[, k]) -> (J, r[, k])."""
    return a @ x if x.ndim == 3 else (a @ x[..., None])[..., 0]


def baseline_metrics(blocks, bvecs, x_ref, x) -> dict:
    """The history row of one iterate: ``mse`` to ``x_ref`` (when given)
    and the global ``residual_sq``, per column for a batched ``x``."""
    out = {}
    if x_ref is not None:
        ref = x_ref[..., None] if x.ndim > x_ref.ndim else x_ref
        d = x - ref
        out["mse"] = torch.mean(d * d, dim=0)
    r = blocks @ x - bvecs
    out["residual_sq"] = torch.sum(r * r, dim=(0, 1))
    return out


def empty_history(initial: dict, num_epochs: int) -> dict:
    """Preallocated ``(E, …)`` history tensors shaped like one metrics row."""
    return {
        key: torch.empty((num_epochs,) + v.shape, dtype=v.dtype, device=v.device)
        for key, v in initial.items()
    }


def _coldot(a, b):
    """⟨a, b⟩ over the solution axis: scalar for (n,), per column for (n, k)."""
    return torch.sum(a * b, dim=0)


def solve_cgnr(
    part: Partition,
    num_epochs: int = 100,
    x_ref: torch.Tensor | None = None,
    tol: float = 0.0,
):
    """CGNR end to end. Returns (x, history dict matching APC's).

    ``part.bvecs`` may carry a trailing (J, p, k) batch axis. ``tol`` is
    accepted and not read, as in the reference: every solve runs
    ``num_epochs`` iterations."""
    blocks, bvecs = part.blocks, part.bvecs
    n = blocks.shape[-1]
    blocks_t = blocks.mT

    def matvec_normal(v):  # Σ_j A_jᵀ (A_j v)
        return block_matvec(blocks_t, blocks @ v).sum(dim=0)

    atb = block_matvec(blocks_t, bvecs).sum(dim=0)
    shape = (n, bvecs.shape[-1]) if bvecs.ndim == 3 else (n,)
    x = torch.zeros(shape, dtype=blocks.dtype, device=blocks.device)
    r = atb - matvec_normal(x)
    p, rs = r, _coldot(r, r)
    initial = baseline_metrics(blocks, bvecs, x_ref, x)
    hist = empty_history(initial, num_epochs)
    for t in range(num_epochs):
        ap = matvec_normal(p)
        alpha = rs / torch.clamp_min(_coldot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _coldot(r, r)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        p = r + beta * p
        rs = rs_new
        for key, v in baseline_metrics(blocks, bvecs, x_ref, x).items():
            hist[key][t] = v
    hist["initial"] = initial
    return x, hist
