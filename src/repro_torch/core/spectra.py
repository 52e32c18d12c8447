"""Per-block spectral estimation and heterogeneity-aware consensus dynamics.

The paper runs eqs. (6)-(7) with ONE global (γ, η) pair, implicitly assuming
the row blocks are spectrally interchangeable. Under data heterogeneity
(skewed nnz, non-i.i.d. rows — the regime of arXiv 2304.10640) the blocks'
projection operators contract at very different rates and the global pair is
tuned for the worst block. The per-block generalization keeps eq. (6) with a
per-block γ_j and turns eq. (7) into the weighted mean

    x̄⁺ = mean_j(η_j · xs_j⁺) + (1 − η̄) · x̄,     η̄ = mean_j(η_j),

which reduces exactly to the scalar update when all η_j coincide. Its
iteration matrix on the consensus error is (1−η̄)I + η̄·Σ_j w_j P_j / J with
w_j = η_j/η̄: a convex combination of projectors, so stability is inherited
from the scalar analysis (arXiv 1708.01413) for any mean-1 weights.

For generic blocks the bulk contraction factor is ≈ 1 − Σ_j (η_j/J)·r_j/n
with r_j the effective rank of block j's row space — so the rate-optimal
weights grow with per-block effective rank. We estimate r_j as the STABLE
RANK trace(G_j)/λmax(G_j) of the block Gram G_j = A_j A_jᵀ: scale-invariant,
and computable from factors ``prepare`` already caches — the trace is the
Gram diagonal sum and λmax comes from a short power iteration on the cached
Gram/QR products. Weights are clipped and renormalized to mean 1, so η̄
equals the user's η exactly and the global tuning story is unchanged.

Host-side numpy, a copy of the JAX package's module (the port never imports
it), except the matrix-free estimator ``block_spectra_matfree``, whose
power iteration runs on the device through the operator's ``gram_mv``.
"""
from __future__ import annotations

import numpy as np
import torch


def _ramp(p: int) -> np.ndarray:
    """Deterministic non-degenerate power-iteration start vector."""
    return 1.0 + np.arange(p, dtype=np.float64) / max(p, 1)


def block_spectra_dense(blocks, plan=None, iters: int = 24) -> dict:
    """Spectral summary of every dense block's Gram G_j = A_j A_jᵀ.

    Returns ``{"lam_max", "trace", "rows", "stable_rank"}`` — all (J,)
    float64. ``rows`` is the REAL (unpadded) row count per block when a
    ``PartitionPlan`` is given; padding/mixing rows contribute their (tiny)
    energy to the trace but are not counted as rows.
    """
    b = np.asarray(blocks, np.float64)
    J, p, _ = b.shape
    trace = np.einsum("jpn,jpn->j", b, b)
    v = np.broadcast_to(_ramp(p), (J, p)).copy()
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-300)
    lam = np.zeros(J)
    for _ in range(iters):
        u = np.einsum("jpn,jp->jn", b, v)
        w = np.einsum("jpn,jn->jp", b, u)
        lam = np.linalg.norm(w, axis=1)
        v = w / np.maximum(lam, 1e-300)[:, None]
    rows = (
        np.asarray(plan.counts, np.float64)
        if plan is not None
        else np.full(J, float(p))
    )
    return {
        "lam_max": lam,
        "trace": trace,
        "rows": rows,
        "stable_rank": trace / np.maximum(lam, 1e-300),
    }


def block_spectra_matfree(op, iters: int = 24) -> dict:
    """Spectral summary of a ``PartitionedBSR``'s block Grams.

    The trace is exact (Gram diagonal sum); λmax comes from a power
    iteration on ``op.gram_mv`` on the operator's device — the stored
    sparse Gram shards when present, rmatvec∘matvec otherwise. Padded rows
    have zero diagonal and stay pinned at zero. The estimate is read back
    once, after the last iteration.
    """
    diag = op.gram_diag().double().cpu().numpy()  # (J, p_pad)
    J, p_pad = diag.shape
    trace = diag.sum(axis=1)
    live = diag > 0
    rows = live.sum(axis=1).astype(np.float64)
    v0 = live * _ramp(p_pad)
    v0 /= np.maximum(np.linalg.norm(v0, axis=1, keepdims=True), 1e-300)
    v = torch.from_numpy(v0[..., None]).to(device=op.device, dtype=op.fwd_data.dtype)
    lam = np.zeros(J)
    nrm = None
    for _ in range(iters):
        w = op.gram_mv(v)
        nrm = torch.linalg.vector_norm(w.reshape(J, -1), dim=1)
        v = w / torch.clamp(nrm, min=1e-30)[:, None, None]
    if nrm is not None:
        lam = nrm.double().cpu().numpy()
    return {
        "lam_max": lam,
        "trace": trace,
        "rows": rows,
        "stable_rank": trace / np.maximum(lam, 1e-300),
    }


def derive_dynamics(
    spectra: dict, floor: float = 0.25, ceil: float = 4.0
) -> tuple[np.ndarray, np.ndarray]:
    """Per-block ``(gamma_weights, eta_weights)`` from a spectral summary.

    η weights follow the SQUARE ROOT of the stable rank, clipped to
    [floor, ceil] and renormalized to MEAN 1 — so the effective η̄ equals
    the user's global η exactly and ``dynamics="per_block"`` never changes
    the stability budget, only the allocation across blocks. The bulk-rate
    model (module docstring) wants weights growing with effective rank,
    but the epochs-to-tolerance count is set by the SLOWEST error mode,
    and modes visible only to a down-weighted block decay at η_j/J — a
    linear-in-rank allocation starves them. The sqrt allocation is the
    measured compromise on skewed two-population systems (sr^1 and sr^2
    are both strictly worse in benchmarks/heterogeneity.py's family).
    γ weights stay 1: the block projections are exact (QR / Gram-solve),
    so the eq. (6) relaxation optimum is block-independent; the vector is
    threaded for API completeness and future inexact-projection schedules.
    """
    sr = np.maximum(np.asarray(spectra["stable_rank"], np.float64), 1e-12)
    w = np.sqrt(sr / sr.mean())
    w = np.clip(w, floor, ceil)
    w = w / w.mean()
    return np.ones_like(w), w


# -- checkpoint serialization shared by the dense + matfree solvers ---------

_SPECTRA_KEYS = ("lam_max", "trace", "rows", "stable_rank")


def dynamics_arrays(solver) -> dict:
    """Plan/weights/spectra arrays for a solver's ``to_state``."""
    arrays: dict = {}
    if solver.plan is not None:
        arrays["plan_assignment"] = np.asarray(
            solver.plan.assignment, np.int32
        )
    if solver.block_eta_weights is not None:
        arrays["block_eta_weights"] = np.asarray(
            solver.block_eta_weights, np.float64
        )
        arrays["block_gamma_weights"] = np.asarray(
            solver.block_gamma_weights, np.float64
        )
    if solver.block_spectra:
        for k in _SPECTRA_KEYS:
            if k in solver.block_spectra:
                arrays["spectra_" + k] = np.asarray(
                    solver.block_spectra[k], np.float64
                )
    return arrays


def dynamics_meta(solver) -> dict:
    """Partition/dynamics metadata for a solver's ``to_state``."""
    meta: dict = {
        "partition": solver.partition,
        "dynamics": solver.dynamics,
    }
    if solver.plan is not None:
        meta["plan"] = {
            "kind": solver.plan.kind,
            "m": int(solver.plan.m),
            "num_blocks": int(solver.plan.num_blocks),
        }
    return meta


def dynamics_state(arrays, meta: dict) -> dict:
    """Invert ``dynamics_arrays``/``dynamics_meta`` into constructor
    kwargs (tolerant of pre-plan states: everything defaults off)."""
    kwargs: dict = {
        "partition": meta.get("partition", "uniform"),
        "dynamics": meta.get("dynamics", "global"),
    }
    if "plan_assignment" in arrays:
        from repro_torch.core.partition import PartitionPlan

        pm = meta["plan"]
        kwargs["plan"] = PartitionPlan(
            m=int(pm["m"]),
            num_blocks=int(pm["num_blocks"]),
            assignment=np.asarray(arrays["plan_assignment"]),
            kind=pm["kind"],
        )
    if "block_eta_weights" in arrays:
        kwargs["block_eta_weights"] = np.asarray(arrays["block_eta_weights"])
        kwargs["block_gamma_weights"] = np.asarray(
            arrays["block_gamma_weights"]
        )
    spectra = {
        k: np.asarray(arrays["spectra_" + k])
        for k in _SPECTRA_KEYS
        if "spectra_" + k in arrays
    }
    if spectra:
        kwargs["block_spectra"] = spectra
    return kwargs
