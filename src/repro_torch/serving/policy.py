"""Serving QoS policy: priority classes, typed request options, and the
deadline-aware batching decision.

The FIFO coalescing loop (``repro_torch.serving.queue``) optimizes
throughput: wait up to ``max_wait_ms`` for ``max_batch`` columns, then
dispatch. That is the right policy for bulk traffic and exactly the wrong
one for a latency request stuck behind a filling batch. This module factors
the *decision* out of the dispatcher so it can be priority- and
deadline-aware (a copy of the JAX package's ``repro.serving.policy``, over
the port's ``SolveOptions``; ``BatchPolicy.decide`` decides exactly as the
reference does):

  * ``Priority`` — two classes. ``BULK`` (the default — a bare
    ``submit(fp, b)`` behaves exactly like the historical FIFO server) rides
    the throughput policy; ``INTERACTIVE`` requests flush in a small early
    batch instead of waiting for the bulk window, and an interactive arrival
    is always dispatched before any pending bulk work.
  * ``SubmitOptions`` — the frozen dataclass declaring ``submit``'s typed
    request surface (priority, deadline, per-request tolerance, warm
    start). The dispatcher's batch-compatibility key is DERIVED from its
    fields (``batch_key``): a field batches columns together iff it is part
    of the solve surface (``SolveOptions``) and not per-column, so adding a
    request knob routes it correctly without a hand-maintained twin list.
  * ``BatchPolicy.decide`` — the pure flush decision: given the clock, the
    per-class pending queues, and a solve-time estimate, return which class
    to flush (strictly interactive-first), why, or when to wake up next.
    ``deadline_ms`` requests pull their flush forward so the batch
    *dispatches* early enough to meet the deadline given the estimated
    solve time — a deadline is latency budget, not queue-wait budget.
  * Admission control — ``max_pending_bulk`` bounds the bulk backlog per
    system; past it, new bulk submits fail fast with ``AdmissionError``
    instead of queueing behind work they cannot meet, so a bulk flood can
    never starve interactive traffic of the shared solver thread for more
    than the in-flight batch.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any

from repro_torch.core.prepared import SolveOptions


class Priority(enum.IntEnum):
    """Request latency class; lower value = served first."""

    INTERACTIVE = 0
    BULK = 1


class AdmissionError(RuntimeError):
    """Raised synchronously by ``submit`` when admission control rejects a
    bulk request (the per-system bulk backlog is at ``max_pending_bulk``)."""


@dataclasses.dataclass(frozen=True)
class SubmitOptions:
    """The single source of truth for ``SolveServer.submit``'s typed request
    surface. ``submit(fp, b)`` without options is the default-options shim
    (bulk priority, no deadline — byte-for-byte the historical behavior).

    ``priority``/``deadline_ms`` steer scheduling only; ``tol`` overrides
    the server's reporting/early-exit tolerance for this request (requests
    with different tolerances never share a batch — see ``batch_key``);
    ``x0`` warm-starts this request's column (sessions attach their
    prediction here; per-column, so it never splits a batch).

    ``max_retries``/``timeout_ms`` steer the fault-containment ladder
    (``repro_torch.serving.queue``): how many plain retries a failing
    request gets before escalating to fallback re-prepare, and the total wall
    budget (enqueue → resolution, measured on the server's injected
    clock) after which containment stops and the future fails with a
    structured ``SolveFailure("timeout")``. Both are recovery-scheduling
    knobs, not solve parameters, so — like ``priority`` — they never
    split a batch (they are not on ``SolveOptions``, and the derived
    ``batch_key`` therefore excludes them).
    """

    priority: Priority = Priority.BULK
    deadline_ms: float | None = None
    tol: float | None = None
    x0: Any = None
    max_retries: int = 1
    timeout_ms: float | None = None

    @classmethod
    def field_names(cls) -> tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(cls))


# batch-compatibility key, DERIVED from SubmitOptions: a field splits
# batches iff it changes the solve itself — i.e. it is part of the
# declared solve surface (SolveOptions) — and is not per-column. priority
# and deadline_ms are scheduling-only (they pick WHEN, not WHAT, to solve)
# and x0 enters per-column through the masked warm-start operand, so today
# this derives to ("tol",); a future shared solve knob on SubmitOptions
# joins the key the moment it is declared on both surfaces.
_BATCH_KEY_FIELDS = tuple(
    name for name in SubmitOptions.field_names()
    if name in SolveOptions.field_names() and name != "x0"
)


def batch_key(options: SubmitOptions) -> tuple:
    """Requests may share a coalesced batch iff their keys are equal."""
    return tuple(getattr(options, name) for name in _BATCH_KEY_FIELDS)


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """When to flush which priority class — pure decision, no IO.

    Bulk keeps the historical throughput policy (``max_batch`` /
    ``max_wait_ms``). Interactive flushes after at most
    ``interactive_max_wait_ms`` (default 0: the next dispatcher wake-up,
    i.e. a small immediate batch) and at most ``interactive_max_batch``
    columns (default: ``max_batch``). A pending interactive request always
    flushes before any bulk batch.
    """

    max_batch: int = 8
    max_wait_ms: float = 2.0
    interactive_max_batch: int | None = None  # None -> max_batch
    interactive_max_wait_ms: float = 0.0
    max_pending_bulk: int | None = None  # None -> admission control off

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if (
            self.interactive_max_batch is not None
            and self.interactive_max_batch < 1
        ):
            raise ValueError(
                "interactive_max_batch must be >= 1, got "
                f"{self.interactive_max_batch}"
            )

    def cap(self, priority: Priority) -> int:
        """Largest batch the class may coalesce."""
        if priority is Priority.INTERACTIVE:
            return self.interactive_max_batch or self.max_batch
        return self.max_batch

    def wait_s(self, priority: Priority) -> float:
        """Longest a request of the class may wait for batchmates."""
        ms = (
            self.interactive_max_wait_ms
            if priority is Priority.INTERACTIVE else self.max_wait_ms
        )
        return ms / 1e3

    def admit(self, priority: Priority, bulk_backlog: int) -> None:
        """Raise ``AdmissionError`` when a bulk request must be rejected."""
        if (
            priority is Priority.BULK
            and self.max_pending_bulk is not None
            and bulk_backlog >= self.max_pending_bulk
        ):
            raise AdmissionError(
                f"bulk backlog at max_pending_bulk={self.max_pending_bulk}; "
                "retry later or submit as INTERACTIVE"
            )

    def decide(
        self,
        now: float,
        pending: dict,  # {Priority: sequence of queued requests}
        solve_s: float = 0.0,
        draining: bool = False,
    ) -> tuple[Priority | None, str | None, float | None]:
        """The flush decision: ``(priority, reason, wake_at)``.

        ``priority is not None`` → flush that class now; ``reason`` is one
        of ``"full" | "timeout" | "deadline" | "drain"`` (the dispatcher's
        flush counters key off it). Otherwise ``wake_at`` is the absolute
        time the decision next changes on its own (earliest wait-window or
        deadline expiry of the candidate class) — the dispatcher sleeps
        until then or until a new arrival.

        Strictly interactive-first: while interactive requests are pending
        the bulk queue is not even considered, so a saturating bulk flood
        cannot delay an interactive flush by more than the batch already on
        the solver thread. Queued items need ``t_enqueue`` and
        ``deadline_at`` (absolute seconds, ``None`` = no deadline) — the
        dispatcher's ``_Pending`` shape. ``solve_s`` is the caller's
        running solve-time estimate: deadline flushes fire at
        ``deadline_at - solve_s``, when waiting longer would spend the
        remaining budget in the queue instead of on the solve.
        """
        for priority in Priority:
            items = pending.get(priority)
            if not items:
                continue
            if draining:
                return priority, "drain", None
            if len(items) >= self.cap(priority):
                return priority, "full", None
            window = min(p.t_enqueue for p in items) + self.wait_s(priority)
            deadline = min(
                (
                    p.deadline_at - solve_s for p in items
                    if p.deadline_at is not None
                ),
                default=None,
            )
            if now >= window:
                return priority, "timeout", None
            if deadline is not None and now >= deadline:
                return priority, "deadline", None
            wake = window if deadline is None else min(window, deadline)
            return None, None, wake
        return None, None, None
