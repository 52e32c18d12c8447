"""Decomposed APC — THE PAPER's contribution (Algorithm 1).

Setup replaces every inversion with reduced QR + triangular substitution:
  eq. (1)  A_j = Q1_j R_j           (reduced QR)
  eq. (2–3) x_j(0) by back-substitution on R_j      — O(n²) not O(n³)
  eq. (4)  P_j = I − Q1ᵀQ1          (projector from the orthogonal factor)
The consensus iteration (eqs. 5–7) is unchanged from classical APC.

The setup is split along its data dependencies so the prepare/solve API can
amortize it across right-hand sides:
  * ``qr_blocks``            — eq. (1)/(4) factors (W_j, R_j); depends on A only.
  * ``initial_from_factors`` — eq. (2–3) substitution; the only b-dependent
    step, O(n²) per block, and batched over a trailing RHS axis.
``setup_decomposed`` composes the two.

Two execution profiles:
  * ``materialize_p=True``  — paper-faithful: dense P_j built per block.
  * ``materialize_p=False`` — implicit P v = v − Wᵀ(W v) (O(np) memory).
``use_kernels=True`` routes the triangular solve and the projector through
the hand-written CUDA kernels (``repro_torch.kernels``); on CPU tensors they
take their plain PyTorch versions.
"""
from __future__ import annotations

import torch

from repro_torch.core import consensus, projections
from repro_torch.core.partition import Partition
from repro_torch.core.projections import batched_mv
from repro_torch.kernels.project import ops as project_ops
from repro_torch.kernels.trisolve import ops as trisolve_ops
from repro_torch.kernels.trisolve.ref import trisolve_ref

# observability for the prepare/solve split: how many times the QR setup
# (the cost prepare() exists to amortize) actually ran in this process
SETUP_STATS = {"qr_calls": 0}


def qr_blocks(blocks: torch.Tensor, mode: str):
    """Paper eq. (1)/(4): per-block reduced QR. Returns (Ws (J,p,n), Rs).

    ``Rs`` is (J, n, n) in the tall regime, (J, p, p) in the wide regime;
    both are contiguous. b-independent — this is the factorization
    ``prepare()`` caches.
    """
    SETUP_STATS["qr_calls"] += 1
    return projections.qr_factor(blocks, mode)


def _trisolve(rs, y, lower: bool, transpose: bool, use_kernels: bool):
    """Triangular solve of op(R_j) (J, n, n) against (J, n) or (J, n, k)."""
    y3 = y[..., None] if y.ndim == 2 else y
    if use_kernels:
        x = trisolve_ops.trisolve(rs, y3.contiguous(), lower=lower, transpose=transpose)
    else:
        x = trisolve_ref(rs, y3, lower=lower, transpose=transpose)
    return x[..., 0] if y.ndim == 2 else x


def initial_from_factors(
    Ws: torch.Tensor,
    Rs: torch.Tensor,
    bvecs: torch.Tensor,  # (J, p) or (J, p, k)
    mode: str,
    use_kernels: bool = False,
):
    """Paper eqs. (2–3): x_j(0) by substitution on cached factors.

    tall: x0 = R⁻¹ Q1ᵀ b (back-substitution); wide: min-norm x0 = Q R⁻ᵀ b
    (forward substitution on Rᵀ, read in place). Batched over a trailing
    RHS axis: bvecs (J, p, k) → x0s (J, n, k).
    """
    if mode == "tall":
        y = batched_mv(Ws.mT, bvecs)  # Q1ᵀ b
        return _trisolve(Rs, y, False, False, use_kernels)
    z = _trisolve(Rs, bvecs, True, True, use_kernels)
    return batched_mv(Ws.mT, z)  # Qᵀᵀ z = Q z


def setup_decomposed(
    blocks: torch.Tensor, bvecs: torch.Tensor, mode: str, use_kernels: bool = False
):
    """Algorithm 1 steps 2–3, decomposed. Returns (x0s (J,n), Ws (J,p,n))."""
    Ws, Rs = qr_blocks(blocks, mode)
    x0s = initial_from_factors(Ws, Rs, bvecs, mode, use_kernels)
    return x0s, Ws


def make_apply(Ws: torch.Tensor, materialize_p: bool, use_kernels: bool = False):
    """Projector application for a (J, n) or batched (J, n, k) consensus
    difference."""
    if materialize_p:
        Ps = projections.materialize(Ws)  # paper-faithful dense P_j
        return lambda v: batched_mv(Ps, v)
    if use_kernels:
        def apply(v):  # v (J, n) or (J, n, k): one launch pair for all
            if v.ndim == 2:
                return project_ops.project(Ws, v[..., None].contiguous())[..., 0]
            return project_ops.project(Ws, v.contiguous())

        return apply
    return lambda v: v - batched_mv(Ws.mT, batched_mv(Ws, v))


def solve_dapc(
    part: Partition,
    gamma: float = 1.0,
    eta: float = 0.9,
    num_epochs: int = 100,
    x_ref: torch.Tensor | None = None,
    materialize_p: bool = True,
    use_kernels: bool = False,
    avg_every: int = 1,
    compress: str | None = None,
    xbar0: torch.Tensor | None = None,
):
    """Decomposed APC end-to-end (paper Algorithm 1). Returns (x̄, history)."""
    x0s, Ws = setup_decomposed(part.blocks, part.bvecs, part.mode, use_kernels)
    apply_fn = make_apply(Ws, materialize_p, use_kernels)
    return consensus.run_consensus(
        x0s,
        apply_fn,
        gamma,
        eta,
        num_epochs,
        x_ref=x_ref,
        blocks=part.blocks,
        bvecs=part.bvecs,
        avg_every=avg_every,
        compress=compress,
        xbar0=xbar0,
    )
