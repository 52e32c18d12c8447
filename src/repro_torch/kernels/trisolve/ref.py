"""Plain PyTorch versions of the batched triangular solve.

``trisolve_ref`` is the library solve; ``trisolve_blocked_plain`` follows
the CUDA kernel's decomposition (64-row blocks in solve order, each block's
off-diagonal products summed over the solved blocks in solve order, then its
diagonal block solved), so the CPU tests pin that blocking on ragged n.
"""
from __future__ import annotations

import torch

TB = 64  # rows of a row block in csrc/trisolve.cu


def trisolve_ref(
    r: torch.Tensor, y: torch.Tensor, lower: bool = False, transpose: bool = False
) -> torch.Tensor:
    """Solve op(R) x = y, op(R) = Rᵀ when ``transpose``; ``lower`` names the
    triangle of op(R). Batched over leading axes like the kernel."""
    return torch.linalg.solve_triangular(r.mT if transpose else r, y, upper=not lower)


def trisolve_blocked_plain(
    r: torch.Tensor, y: torch.Tensor, lower: bool = False, transpose: bool = False
) -> torch.Tensor:
    """``trisolve_ref``'s function for R (J, n, n), y (J, n, k), computed row
    block by row block as ``csrc/trisolve.cu`` does."""
    op_r = r.mT if transpose else r
    n, tb = y.shape[-2], TB
    nblk = -(-n // tb)
    order = range(nblk) if lower else range(nblk - 1, -1, -1)
    x = torch.empty_like(y)
    done = []  # row blocks solved so far, in solve order
    for b in order:
        rows = slice(b * tb, min(n, (b + 1) * tb))
        acc = torch.zeros_like(y[..., rows, :])
        for s in done:
            cols = slice(s * tb, min(n, (s + 1) * tb))
            acc = acc + op_r[..., rows, cols] @ x[..., cols, :]
        x[..., rows, :] = torch.linalg.solve_triangular(
            op_r[..., rows, rows], y[..., rows, :] - acc, upper=not lower)
        done.append(b)
    return x
