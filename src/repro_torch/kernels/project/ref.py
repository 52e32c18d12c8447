"""Plain PyTorch version of the fused consensus update — materializes the
dense projector exactly like the paper's reference implementation."""
from __future__ import annotations

import torch


def _block_gamma(gamma, ndim: int):
    """Scalar γ, or a (J,) vector shaped to broadcast over (J, n, k)."""
    if isinstance(gamma, torch.Tensor) and gamma.ndim >= 1:
        return gamma.to(torch.float32).reshape(gamma.shape + (1,) * (ndim - gamma.ndim))
    return float(gamma)


def consensus_update_ref(
    w: torch.Tensor,  # (J, p, n)
    x: torch.Tensor,  # (J, n, k)
    xbar: torch.Tensor,  # (J, n, k)
    gamma=1.0,  # scalar or (J,)
) -> torch.Tensor:
    """x + γ (I − WᵀW)(x̄ − x) with explicit P (O(n²) memory), in f32."""
    n = w.shape[-1]
    wf = w.to(torch.float32)
    P = torch.eye(n, dtype=torch.float32, device=w.device) - wf.mT @ wf
    xf = x.to(torch.float32)
    v = xbar.to(torch.float32) - xf
    return (xf + _block_gamma(gamma, x.ndim) * (P @ v)).to(x.dtype)


def project_ref(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(I − WᵀW) v with explicit P."""
    return consensus_update_ref(w, torch.zeros_like(v), v, 1.0)
