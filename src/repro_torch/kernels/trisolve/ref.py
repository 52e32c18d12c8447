"""Plain PyTorch version of the batched triangular solve."""
from __future__ import annotations

import torch


def trisolve_ref(
    r: torch.Tensor, y: torch.Tensor, lower: bool = False, transpose: bool = False
) -> torch.Tensor:
    """Solve op(R) x = y, op(R) = Rᵀ when ``transpose``; ``lower`` names the
    triangle of op(R). Batched over leading axes like the kernel."""
    return torch.linalg.solve_triangular(r.mT if transpose else r, y, upper=not lower)
