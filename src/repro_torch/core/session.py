"""Streaming prediction-correction solves: the ``Session`` API.

One-shot solves treat every right-hand side as unrelated, but tracking,
control and repeated probes against drifting data present a *sequence* b_t
against one fixed A. A warm-started predict-then-correct consensus step
converges in a fraction of the epochs an independent solve pays (arXiv
2309.09819): the drift between consecutive solutions is tiny next to the
solutions themselves, and the consensus iteration only has to dissipate the
drift error.

A ``Session`` (opened with ``PreparedSolver.open_session`` or its matfree
counterpart) holds the stream state and runs one predict+correct step per
``update(b_t)``:

  * **predict** — extrapolate the solution drift from the incoming
    right-hand side: with db_t = b_t − b_{t−1} and the previous solution
    step dx_{t−1}, the predictor scales the drift by the projection
    coefficient α = ⟨db_t, db_{t−1}⟩ / ‖db_{t−1}‖² (per column, clamped),
    giving x_pred = x_{t−1} + α·dx_{t−1}. Until two updates of history
    exist — or under ``predict="warm"`` — the prediction is the plain warm
    start x_pred = x_{t−1}; ``predict="none"`` makes every update a cold
    solve.
  * **correct** — a consensus solve warm-started at the prediction: the
    solver projects x_pred onto every block's solution set
    (x_j(0) = x_pred + A_j⁺(b_j − A_j x_pred) on the cached factors, see
    ``solve(..., x0=...)``), so the whole consensus state starts near the
    fixed point and ``tol`` freezes the columns after a handful of epochs.
    Each update returns an ordinary ``SolveResult``; ``iterations_to_tol``
    is the receipt.

The predictor is host-side numpy on O(n·k) vectors; each update moves its
prediction to the device once, inside the solver's ``solve``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.prepared import SolveResult

PREDICT_MODES = ("auto", "extrapolate", "warm", "none")

# sessions correct with the consensus iteration; the projection warm start
# is defined for the methods that have block projectors
SESSION_METHODS = ("apc", "dapc")

# extrapolation coefficient clamp: a near-orthogonal or noisy db pair must
# not fling the prediction far outside the observed drift scale
ALPHA_MAX = 4.0


def extrapolate_prediction(
    x: np.ndarray,  # (n,) | (n, k)  — last solution
    dx: np.ndarray,  # same shape     — last solution step x_{t-1} − x_{t-2}
    db: np.ndarray,  # (m,) | (m, k)  — incoming RHS step b_t − b_{t-1}
    db_prev: np.ndarray,  # same shape — previous RHS step b_{t-1} − b_{t-2}
) -> np.ndarray:
    """Drift extrapolation x_pred = x + α·dx with per-column
    α = ⟨db, db_prev⟩/‖db_prev‖² clamped to ±``ALPHA_MAX``.

    The solution drift is linear in the RHS drift (A·dx = db for square /
    consistent systems), so the coefficient that maps the previous RHS step
    onto the incoming one maps the solution step the same way: constant
    drift gives α = 1 (plain velocity extrapolation), a reversing probe
    gives α = −1, and an uncorrelated jump gives α ≈ 0 (falls back to the
    warm start). A vanishing previous step also degrades to α = 0.
    """
    num = np.sum(db * db_prev, axis=0)
    den = np.sum(db_prev * db_prev, axis=0)
    safe = den > 1e-30
    alpha = np.where(safe, num / np.where(safe, den, 1.0), 0.0)
    alpha = np.clip(alpha, -ALPHA_MAX, ALPHA_MAX)
    return (x + alpha * dx).astype(x.dtype, copy=False)


class DriftPredictor:
    """Host-side predict state for one b_t stream: (x, dx, b, db) history.

    ``predict(b_t)`` returns the warm-start estimate for the incoming RHS
    (or ``None`` for a cold solve); ``observe(b_t, x_t)`` records the
    solved update. Shapes are whatever the stream solves — ``(n,)``
    columns or ``(n, k)`` batches (each column extrapolated
    independently). ``Session`` holds one; a serving layer's per-request
    streams hold one each, so the surfaces cannot drift apart on
    prediction semantics.
    """

    def __init__(self, predict: str = "auto"):
        if predict not in PREDICT_MODES:
            raise ValueError(
                f"predict must be one of {PREDICT_MODES}, got {predict!r}"
            )
        self.mode = predict
        self.reset()

    def reset(self) -> None:
        """Drop all history — the next update solves cold."""
        self._x = self._b = self._dx = self._db = None

    @property
    def has_history(self) -> bool:
        return self._x is not None

    def predict(self, b: np.ndarray) -> np.ndarray | None:
        """Warm-start estimate for the incoming ``b``, or None (cold)."""
        if self.mode == "none" or self._x is None:
            return None
        if self.mode == "warm" or self._dx is None:
            return self._x.copy()
        db = np.asarray(b, self._b.dtype) - self._b
        return extrapolate_prediction(self._x, self._dx, db, self._db)

    def observe(self, b: np.ndarray, x: np.ndarray) -> None:
        """Record a solved update (call once per update, after the solve)."""
        b = np.asarray(b)
        x = np.asarray(x)
        if self._x is not None and x.shape == self._x.shape:
            self._dx = x - self._x
            self._db = b - self._b
        else:  # first update, or the stream changed width: restart history
            self._dx = self._db = None
        self._x, self._b = x, b


@dataclasses.dataclass
class Session:
    """A prediction-correction stream over one prepared solver.

    Opened by ``PreparedSolver.open_session(...)`` (and the matfree
    solver — the session is path-agnostic: it only calls
    ``solver.solve(b, x0=prediction, ...)``). Each ``update(b_t)`` runs
    one predict+correct step and returns the ordinary ``SolveResult``;
    the per-update saving shows up in ``iterations_to_tol`` and the
    cumulative ``total_epochs``.

    ``num_epochs`` stays the full cold-solve budget — it is the CAP, not
    the cost: with ``tol`` set, converged columns freeze on every path
    (masked early exit), so a warm update's trailing epochs are
    carry-through vector ops, and ``iterations_to_tol(tol)`` reports the
    true per-update epoch count. ``gamma``/``eta``/``solve_kwargs``
    override the solver's defaults per session.
    """

    solver: Any  # PreparedSolver | MatrixFreePreparedSolver
    num_epochs: int = 100
    tol: float | None = None
    predict: str = "auto"
    gamma: float | None = None
    eta: float | None = None
    solve_kwargs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.solver.method not in SESSION_METHODS:
            raise ValueError(
                f"sessions correct with the consensus methods "
                f"{SESSION_METHODS}; got a {self.solver.method!r} solver"
            )
        self._predictor = DriftPredictor(self.predict)
        self._updates = 0
        self._total_epochs = 0

    @property
    def num_updates(self) -> int:
        return self._updates

    @property
    def total_epochs(self) -> int:
        """Cumulative per-column epochs-to-tolerance across all updates
        (per-column ``num_epochs`` for updates that never converged, and
        for every update when the session has no ``tol``) — the quantity to
        hold against independent solves."""
        return self._total_epochs

    @property
    def last_x(self) -> np.ndarray | None:
        """The most recent update's solution (the next warm-start seed)."""
        return None if self._predictor._x is None else self._predictor._x

    def reset(self) -> None:
        """Forget the stream history; the next update solves cold."""
        self._predictor.reset()

    def update(self, b: np.ndarray, **overrides) -> SolveResult:
        """Predict from the stream history, correct against ``b``, record.

        ``b`` is one RHS ``(m,)`` or a column batch ``(m, k)`` — a batched
        session tracks k independent streams in one batch (each
        column predicts from its own history). ``overrides`` forward to
        ``solver.solve`` for this update only (e.g. ``num_epochs=``).
        """
        b = np.asarray(b)
        x0 = self._predictor.predict(b)
        kwargs = {**self.solve_kwargs, **overrides}
        kwargs.setdefault("num_epochs", self.num_epochs)
        if self.gamma is not None:
            kwargs.setdefault("gamma", self.gamma)
        if self.eta is not None:
            kwargs.setdefault("eta", self.eta)
        if self.tol is not None:
            kwargs.setdefault("tol", self.tol)
        res = self.solver.solve(b, x0=x0, **kwargs)
        self._predictor.observe(b, res.x)
        self._updates += 1
        tol = kwargs.get("tol")
        if tol is not None:
            self._total_epochs += int(res.iterations_to_tol(tol).sum())
        else:
            k = res.x.shape[1] if res.x.ndim == 2 else 1
            self._total_epochs += int(kwargs["num_epochs"]) * k
        return res
