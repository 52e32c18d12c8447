"""Classical Accelerated Projection-Based Consensus (Azizan-Ruhi et al. 2017).

The baseline the paper accelerates: per-block setup uses SVD-based
pseudoinverses / Gram-matrix inverses (the exact costs the decomposition
removes), and the projector is materialized densely.

Mirrors dapc's prepare/solve split: ``classical_factors`` (pseudoinverse +
dense projector, b-independent) and ``initial_from_pinv`` (one matmul per
RHS), so classical APC amortizes setup across right-hand sides too.
"""
from __future__ import annotations

import torch

from repro_torch.core import consensus, projections
from repro_torch.core.partition import Partition
from repro_torch.core.projections import batched_mv


def classical_factors(blocks: torch.Tensor, mode: str):
    """Per-block (A_j⁺ (J,n,p), P_j (J,n,n)) — the classical setup costs."""
    pinvs = projections.pinv(blocks)
    Ps = projections.classical_projection(blocks, mode)
    return pinvs, Ps


def initial_from_pinv(pinvs: torch.Tensor, bvecs: torch.Tensor) -> torch.Tensor:
    """x_j(0) = A_j⁺ b_j for one RHS (J, p) or a batch (J, p, k)."""
    return batched_mv(pinvs, bvecs)


def setup_classical(blocks: torch.Tensor, bvecs: torch.Tensor, mode: str):
    """Per-block (x_j(0), P_j) via pseudoinverse — Algorithm 1 steps 2–3,
    classical variant. Returns (x0s (J,n), Ps (J,n,n))."""
    x0s = projections.classical_initial(blocks, bvecs, mode)
    Ps = projections.classical_projection(blocks, mode)
    return x0s, Ps


def make_apply(Ps: torch.Tensor):
    """Dense projector application, batched over a trailing RHS axis."""
    return lambda v: batched_mv(Ps, v)


def solve_apc(
    part: Partition,
    gamma: float = 1.0,
    eta: float = 0.9,
    num_epochs: int = 100,
    x_ref: torch.Tensor | None = None,
):
    """Classical APC end-to-end. Returns (x̄, history)."""
    x0s, Ps = setup_classical(part.blocks, part.bvecs, part.mode)
    return consensus.run_consensus(
        x0s,
        make_apply(Ps),
        gamma,
        eta,
        num_epochs,
        x_ref=x_ref,
        blocks=part.blocks,
        bvecs=part.bvecs,
    )
