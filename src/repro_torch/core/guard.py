"""Solve watchdog: NaN/Inf and stall detection over the residual history.

A stalled consensus loop burns its full epoch budget and returns garbage
with ``converged=False`` buried in the per-column report. This module turns
the residual history every solve records (dense ``run_consensus``, matfree
``consensus_epochs``) into a structured health verdict:

  * ``Watchdog`` — the detection policy (pure config: stall window, decay
    bound, floors). ``assess`` classifies each column of a ``SolveResult``
    (or a raw ``(E, k)`` residual trace) as ``ok`` / ``nan`` / ``stalled``.
  * ``SolveHealth`` — the per-column verdict a serving layer keys its
    recovery off: NaN columns retry on fresh factors, stalled columns
    escalate to a fallback path.

Everything here is host-side numpy, after the solve: the detector reads the
per-epoch residuals the solve already returned in ``history`` and never
touches the solve itself, so guarded and unguarded solves are bit-identical.

Stall semantics are conservative — flagged only when ALL of: the column did
not reach the convergence tolerance, its residual is above the absolute and
relative floors (a column frozen at the float32 floor is done, not stuck),
and the residual shrank by less than ``stall_decay`` over the trailing
``stall_window`` epochs.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

STATUS_OK = "ok"
STATUS_NAN = "nan"
STATUS_STALLED = "stalled"


@dataclasses.dataclass(frozen=True)
class SolveHealth:
    """Per-column health verdict for one (possibly batched) solve."""

    status: tuple[str, ...]  # per column: "ok" | "nan" | "stalled"
    checked_epochs: int  # length of the residual trace examined

    @property
    def ok(self) -> bool:
        return all(s == STATUS_OK for s in self.status)

    @property
    def nan_columns(self) -> tuple[int, ...]:
        return tuple(
            i for i, s in enumerate(self.status) if s == STATUS_NAN
        )

    @property
    def stalled_columns(self) -> tuple[int, ...]:
        return tuple(
            i for i, s in enumerate(self.status) if s == STATUS_STALLED
        )

    @property
    def sick_columns(self) -> tuple[int, ...]:
        """Columns needing recovery (union of nan + stalled, in order)."""
        return tuple(
            i for i, s in enumerate(self.status) if s != STATUS_OK
        )

    def column_ok(self, i: int) -> bool:
        return self.status[i] == STATUS_OK


@dataclasses.dataclass(frozen=True)
class Watchdog:
    """Detection policy — pure config, no solver state.

    ``stall_window`` epochs of trailing history are examined; a column is
    stalled when its residual shrank by a factor worse (larger) than
    ``stall_decay`` over that window while still above tolerance and both
    floors. ``floor_abs`` exempts columns already at numerical zero (e.g.
    the zero-padded bucket columns the serving layer appends);
    ``floor_ratio`` exempts columns that already shrank their initial
    residual by 10 orders of magnitude — flat-at-the-float32-floor is
    convergence, not a stall.
    """

    stall_window: int = 8
    stall_decay: float = 0.99  # < 1% decay over the window = stalled
    floor_abs: float = 1e-12
    floor_ratio: float = 1e-10

    def assess(
        self, result: Any, tol: float | None = None
    ) -> SolveHealth:
        """Classify each column of ``result``.

        ``result`` may be a ``SolveResult`` (its ``history`` residual trace
        and solution are examined), a history dict with ``"residual_sq"``,
        or a raw per-epoch residual array ``(E,)`` / ``(E, k)``. ``tol`` is
        the convergence tolerance the solve was judged against: columns at
        or below it are healthy no matter how flat their trailing trace is
        (the masked early exit freezes them on purpose).
        """
        trace, x = _residuals_and_solution(result)
        E, k = trace.shape
        tol_sq = None if tol is None else float(tol) ** 2
        status = []
        for i in range(k):
            col = trace[:, i]
            final = col[-1]
            if not np.isfinite(final) or not np.isfinite(col).all():
                status.append(STATUS_NAN)
                continue
            if x is not None and not np.isfinite(x[:, i]).all():
                status.append(STATUS_NAN)
                continue
            if tol_sq is not None and final <= tol_sq:
                status.append(STATUS_OK)  # converged (possibly frozen)
                continue
            if final <= self.floor_abs:
                status.append(STATUS_OK)  # numerically exact (zero column)
                continue
            first = col[0]
            if first > 0 and final / first <= self.floor_ratio:
                status.append(STATUS_OK)  # at the dtype floor = done
                continue
            w = int(self.stall_window)
            if E <= w:
                status.append(STATUS_OK)  # too short a trace to judge
                continue
            anchor = col[-1 - w]
            if anchor <= 0:  # was exactly solved, then flat
                status.append(STATUS_OK)
                continue
            if final / anchor > self.stall_decay:
                status.append(STATUS_STALLED)
            else:
                status.append(STATUS_OK)
        return SolveHealth(status=tuple(status), checked_epochs=E)


def _residuals_and_solution(result: Any):
    """Normalize guard input to ``(trace (E, k), x (n, k) | None)``."""
    x = None
    if hasattr(result, "history"):  # SolveResult-shaped
        h = result.history.get("residual_sq")
        if h is None:
            raise ValueError(
                f"method {getattr(result, 'method', '?')!r} recorded no "
                "residual history; the watchdog rides the residual carry"
            )
        xr = getattr(result, "x", None)
        if xr is not None:
            xr = np.asarray(xr)
            x = xr[:, None] if xr.ndim == 1 else xr
    elif isinstance(result, dict):
        h = result.get("residual_sq")
        if h is None:
            raise ValueError(
                "history dict has no 'residual_sq' trace for the watchdog"
            )
    else:
        h = result
    trace = np.asarray(h)
    if trace.ndim == 1:
        trace = trace[:, None]
    return trace, x


def assess(
    result: Any, tol: float | None = None, watchdog: Watchdog | None = None
) -> SolveHealth:
    """Module-level shorthand: ``(watchdog or Watchdog()).assess(...)``."""
    return (watchdog or Watchdog()).assess(result, tol=tol)
