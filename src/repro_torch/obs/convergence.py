"""Convergence diagnostics: per-block residual decay — the numbers behind
"which block is dragging convergence".

``SolveResult.history`` aggregates the residual over blocks, which hides
APC's failure mode (arXiv 2304.10640): when block spectra are imbalanced,
one block's slow projection contraction dominates eq. 9's spectral-radius
bound (arXiv 1708.01413) while the aggregate still looks like smooth
geometric decay. Both solve paths (dense consensus and matfree) record
``history["block_residual_sq"]`` — per-epoch, per-block ``||A_j x̄ − b_j||²``
— under ``solve(..., block_history=True)``, and this module turns that
trace into decisions:

  * ``block_residual_history`` — normalize to ``(E, J, k)``;
  * ``per_block_rates`` — per-block geometric decay rate estimates, the
    empirical per-block spectral radii of eq. 9;
  * ``convergence_report`` — slowest/fastest block, imbalance ratio, and
    per-block epochs-to-tolerance.

Host-side numpy over the history a solve already returned.
``audit_epoch_collectives`` and ``collect_reduces`` count the collectives
of a multi-device epoch, which the port does not run yet.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# per-block residual history
# ---------------------------------------------------------------------------


def block_residual_history(result) -> np.ndarray:
    """The per-block residual trace as ``(E, J, k)`` (k=1 for one RHS).

    ``result`` is a ``SolveResult`` (or any object with a ``history``
    dict) from a solve run with ``block_history=True``; raises with the
    enabling hint otherwise.
    """
    hist = result.history if hasattr(result, "history") else result
    trace = hist.get("block_residual_sq")
    if trace is None:
        raise ValueError(
            "history has no 'block_residual_sq' — run the solve with "
            "block_history=True (consensus methods: the dense and the "
            "matfree paths record it)"
        )
    trace = np.asarray(trace)
    return trace[..., None] if trace.ndim == 2 else trace


def per_block_rates(result, eps: float = 1e-30, plan=None):
    """Per-block geometric decay rate estimates, shape ``(J, k)``.

    Fits ``r_j(t) ≈ r_j(0)·ρ_j^t`` on the residual NORM (the history
    stores squares, hence the 1/2): ``ρ_j = (r_j(E)/r_j(0))^(1/(2E))``.
    This is the empirical per-block contraction factor — the quantity
    eq. 9 of arXiv 1708.01413 bounds by the projector spectral radius —
    so a block whose ρ_j sits near 1 while its siblings contract is the
    heterogeneity signature. Frozen/converged columns (tol early exit)
    repeat their final residual, which only flattens the estimate toward
    its true converged value, never inflates it.

    With a ``PartitionPlan`` (the solver's ``prep.plan``) the return is
    ``{"rates", "labels"}``: ``labels[j]`` maps block ``j`` back to its
    ORIGINAL row ranges (``plan.describe_block``), so a cost-aware plan's
    scattered blocks stay attributable to the input rows that formed them.
    """
    trace = block_residual_history(result)
    E = trace.shape[0]
    if E < 2:
        raise ValueError(f"need >= 2 epochs to fit a rate, got {E}")
    first = np.maximum(trace[0], eps)
    last = np.maximum(trace[-1], eps)
    rates = (last / first) ** (1.0 / (2.0 * (E - 1)))
    if plan is None:
        return rates
    return {
        "rates": rates,
        "labels": [plan.describe_block(j) for j in range(trace.shape[1])],
    }


def convergence_report(result, tol: float | None = None, plan=None) -> dict:
    """Summarize a per-block trace: who is dragging, and by how much.

    Returns (arrays are per-column where applicable):
      * ``rates`` — ``(J, k)`` per-block decay rates (``per_block_rates``);
      * ``slowest_block`` / ``fastest_block`` — ``(k,)`` block indices by
        final residual share;
      * ``imbalance`` — ``(k,)`` slowest/fastest final-residual ratio (1.0
        = perfectly balanced decay, the uniform-partition ideal);
      * ``block_epochs_to_tol`` — ``(J, k)`` epochs until each BLOCK's
        residual_sq reached ``tol²/J`` (its fair share of a global
        tolerance), ``num_epochs`` when it never did — only with ``tol``;
      * ``block_labels`` — with a ``PartitionPlan``, each block's original
        row ranges (``plan.describe_block``) so the report reads in input
        coordinates even for scattered cost-aware blocks.
    """
    trace = block_residual_history(result)
    E, J, _ = trace.shape
    final = trace[-1]
    rates = per_block_rates(result)
    out = {
        "num_epochs": E,
        "num_blocks": J,
        "rates": rates,
        "slowest_block": np.argmax(final, axis=0),
        "fastest_block": np.argmin(final, axis=0),
        "imbalance": np.max(final, axis=0)
        / np.maximum(np.min(final, axis=0), 1e-30),
        "final_block_residual_sq": final,
    }
    if plan is not None:
        out["block_labels"] = [plan.describe_block(j) for j in range(J)]
    if tol is not None:
        share = float(tol) ** 2 / J
        reached = trace <= share
        out["block_epochs_to_tol"] = np.where(
            reached.any(axis=0), reached.argmax(axis=0) + 1, E
        ).astype(np.int64)
    return out


# ---------------------------------------------------------------------------
# collective-count audit
# ---------------------------------------------------------------------------


def audit_epoch_collectives(*args, **kwargs) -> dict:
    """The per-epoch collective budget of a sharded solve: the port has no
    multi-device path yet, so there is nothing to audit."""
    raise NotImplementedError(
        "audit_epoch_collectives counts the collectives of the multi-device "
        "solve, not ported yet: ROADMAP Queue 1 item 8 (multi-device)"
    )


def collect_reduces(*args, **kwargs):
    """The all-reduces of a sharded epoch's program: the port has no
    multi-device path yet, so there is nothing to collect."""
    raise NotImplementedError(
        "collect_reduces lists the collectives of the multi-device solve, "
        "not ported yet: ROADMAP Queue 1 item 8 (multi-device)"
    )
