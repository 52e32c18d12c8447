"""The single monotonic clock behind every latency number.

Mixing ``asyncio``'s ``loop.time()`` with ``time.perf_counter()`` — two
monotonic sources whose epochs differ — makes a duration computed across
them garbage and deterministic tests impossible. Everything in the serving
stack that accounts latency (``queue_ms``/``solve_ms``, the EWMA solve
estimate, deadline arithmetic, checkpoint restore timing, span timestamps)
reads ONE injectable clock:

  * ``now()`` / the module-level ``DEFAULT`` — ``time.monotonic()``, the
    production source;
  * ``ManualClock`` — starts at an arbitrary origin and only moves when
    the test calls ``advance``; inject it into ``SolveServer(clock=...)``
    / ``PreparedPool(clock=...)`` / ``Tracer(clock=...)`` and latency
    accounting becomes exact instead of sleep-and-hope.

Durations only — none of these clocks share an epoch with wall time, so
never compare readings across clock instances or persist them as
timestamps (trace exports rebase to the trace's own origin).
"""
from __future__ import annotations

import time


class Clock:
    """Monotonic seconds; the production clock. Stateless and shareable."""

    def now(self) -> float:
        return time.monotonic()


class ManualClock(Clock):
    """Deterministic clock for tests: reads return the set time, and time
    only passes through ``advance`` (or assigning ``current``)."""

    def __init__(self, start: float = 0.0):
        self.current = float(start)

    def now(self) -> float:
        return self.current

    def advance(self, seconds: float) -> float:
        """Move the clock forward; returns the new reading."""
        if seconds < 0:
            raise ValueError(f"time only moves forward, got {seconds}")
        self.current += float(seconds)
        return self.current


DEFAULT = Clock()


def now() -> float:
    """The default monotonic reading (``DEFAULT.now()``)."""
    return DEFAULT.now()
