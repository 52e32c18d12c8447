"""Convergence diagnostics: per-block residual decay — the numbers behind
"which block is dragging convergence".

``SolveResult.history`` aggregates the residual over blocks, which hides
APC's failure mode (arXiv 2304.10640): when block spectra are imbalanced,
one block's slow projection contraction dominates eq. 9's spectral-radius
bound (arXiv 1708.01413) while the aggregate still looks like smooth
geometric decay. The solve paths (dense consensus, matfree and sharded
matfree) record ``history["block_residual_sq"]`` — per-epoch, per-block ``||A_j x̄ − b_j||²``
— under ``solve(..., block_history=True)``, and this module turns that
trace into decisions:

  * ``block_residual_history`` — normalize to ``(E, J, k)``;
  * ``per_block_rates`` — per-block geometric decay rate estimates, the
    empirical per-block spectral radii of eq. 9;
  * ``convergence_report`` — slowest/fastest block, imbalance ratio, and
    per-block epochs-to-tolerance.

Host-side numpy over the history a solve already returned.

It also owns the collective audit of the sharded matrix-free solver:
``audit_epoch_collectives`` runs a real solve with its ``Collectives``
wrapper recording, and counts the calls each epoch made (``collect_reduces``
flags each call by epoch membership), so any run — a test, a notebook, a
serving deployment — can assert its per-epoch comms budget.
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
            "block_history=True (consensus methods: dense, matfree, and "
            "sharded paths all record it)"
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
# collective-count audit (the calls a real solve makes; no wall clock)
# ---------------------------------------------------------------------------


def collect_reduces(calls) -> list:
    """Recorded collective calls (a ``Recorder`` or its ``calls``) as
    ``(in_epoch, op, numel)`` triples — numel in output elements. ``in_epoch``
    flags the calls made inside the epoch loop, i.e. the ones an EPOCH pays."""
    calls = getattr(calls, "calls", calls)
    return [(epoch is not None, op, numel) for epoch, op, numel in calls]


def audit_epoch_collectives(
    prep,
    b,
    num_epochs: int = 8,
    tol: float | None = None,
    block_history: bool = False,
    max_payload_elems: int | None = None,
    max_ops: int | None = None,
    bvecs=None,
) -> dict:
    """Run one cold sharded solve and account the collectives of its epochs.

    Returns ``{"payload_elems", "ops", "found"}``: ``payload_elems`` / ``ops``
    cover the calls made INSIDE one epoch (the most any epoch made;
    every epoch makes the same calls), ``found`` every call of the solve as
    ``collect_reduces`` triples. With ``max_payload_elems`` / ``max_ops`` set
    it asserts the budget.

    ``prep`` is a ``ShardedMatrixFreeSolver``, and every rank of its mesh
    must make this call (it runs a solve); a single-device solver makes no
    collectives and passes any budget. ``b`` is the whole right-hand side
    — or pass this rank's block-partitioned ``bvecs`` directly. A solver
    prepared with ``dynamics="per_block"`` is audited with the per-block
    (γ_j, η_j) operands armed.
    """
    comm = getattr(prep, "comm", None)
    if comm is None:
        return {"payload_elems": 0, "ops": 0, "found": []}
    if bvecs is None:
        bvecs = prep.block_rhs(np.asarray(b))
    per_block = (
        getattr(prep, "dynamics", "global") == "per_block"
        and getattr(prep, "block_eta_weights", None) is not None
    )
    gamma_op, eta_op = prep._dynamics_operands(prep.gamma, prep.eta, per_block)
    with comm.recording() as rec:
        prep._epochs(
            bvecs, gamma_op, eta_op, None, None, tol=tol, num_epochs=num_epochs,
            inner_iters=prep.inner_iters, block_history=block_history,
        )
    epochs = [[c for c in rec.calls if c[0] == t] for t in range(num_epochs)]
    payload = max((sum(c[2] for c in calls) for calls in epochs), default=0)
    ops = max((len(calls) for calls in epochs), default=0)
    in_epoch = epochs[0] if epochs else []
    if max_payload_elems is not None and payload > max_payload_elems:
        raise AssertionError(
            f"epoch pays {payload} collective elements > budget "
            f"{max_payload_elems} (ops: {in_epoch})"
        )
    if max_ops is not None and ops > max_ops:
        raise AssertionError(
            f"epoch pays {ops} collectives > budget {max_ops} (ops: {in_epoch})"
        )
    return {"payload_elems": payload, "ops": ops, "found": collect_reduces(rec)}
