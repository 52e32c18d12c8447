"""Span-based request tracing with JSON-lines and Chrome trace-event export.

Answers "where did this request's 40 ms go": every request through the
serving stack gets a trace id, and each stage it crosses — submit/queue
wait, batch dispatch, the coalesced solve, checkpoint restores, session
updates — records one host-side span ``(name, trace_id, t0, t1, args)``.
Spans are HOST-side only: the solve loop is never touched per-epoch, so
an enabled tracer costs a few dict appends per request, and a disabled one
costs nothing at all (callers hold ``tracer=None`` and skip the calls).

Exports:

  * ``export_jsonl`` — one span per line, machine-greppable; the input
    format ``tools/trace_report.py`` summarizes.
  * ``export_chrome`` — Chrome trace-event JSON (``{"traceEvents": [...]}``,
    complete ``"ph": "X"`` events). Open the file directly in Perfetto
    (ui.perfetto.dev) or chrome://tracing: each request renders as its own
    track (``tid`` = trace id), server-side batch/pool spans on track 0,
    so a serving run's queue→dispatch→solve waterfall is visible without
    any post-processing.

Timestamps come from the injectable ``repro_torch.obs.clock`` (monotonic);
the Chrome export rebases them to the earliest span so Perfetto's clock
starts near zero. The span formats are the JAX package's, so
``tools/trace_report.py`` reads either package's exports.
"""
from __future__ import annotations

import itertools
import json
import threading
from contextlib import contextmanager
from typing import Any

from repro_torch.obs import clock as obs_clock

SERVER_TRACK = 0  # tid for spans not owned by one request (batches, pool IO)


class Span:
    """One in-flight span; ``end()`` seals it into the tracer's buffer.

    ``trace_id`` groups spans of one logical request; ``args`` carry
    structured attributes (batch size, fingerprint, flush reason, ...).
    """

    __slots__ = ("tracer", "name", "cat", "trace_id", "t0", "t1", "args")

    def __init__(self, tracer, name, cat, trace_id, t0, args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.t0 = t0
        self.t1 = None
        self.args = args

    def set(self, **args) -> "Span":
        """Attach attributes discovered mid-span (e.g. batch size)."""
        self.args.update(args)
        return self

    def end(self, **args) -> "Span":
        if self.t1 is None:  # idempotent: double-end keeps the first seal
            self.args.update(args)
            self.t1 = self.tracer._clock.now()
            self.tracer._seal(self)
        return self

    @property
    def duration_ms(self) -> float:
        return 0.0 if self.t1 is None else (self.t1 - self.t0) * 1e3


class Tracer:
    """Collects spans; thread-safe (spans begin on the event loop and end
    on the solver thread). One tracer per serving run — trace ids are
    unique within a tracer, not globally."""

    def __init__(self, clock=None):
        self._clock = clock or obs_clock.DEFAULT
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        self._ids = itertools.count(1)

    def new_trace_id(self) -> int:
        return next(self._ids)

    def begin(
        self, name: str, trace_id: int = SERVER_TRACK,
        cat: str = "serving", **args: Any,
    ) -> Span:
        """Open a span at now(); seal it with ``span.end()``."""
        return Span(self, name, cat, trace_id, self._clock.now(), args)

    def span_at(
        self, name: str, t0: float, t1: float,
        trace_id: int = SERVER_TRACK, cat: str = "serving", **args: Any,
    ) -> Span:
        """Record an already-measured interval (both endpoints known) —
        how the dispatcher back-fills each request's queue span at
        dispatch time without touching the submit hot path."""
        span = Span(self, name, cat, trace_id, t0, args)
        span.t1 = t1
        self._seal(span)
        return span

    @contextmanager
    def span(self, name: str, trace_id: int = SERVER_TRACK,
             cat: str = "serving", **args: Any):
        span = self.begin(name, trace_id, cat, **args)
        try:
            yield span
        finally:
            span.end()

    def _seal(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self) -> list[Span]:
        """Snapshot of the sealed spans, in seal order."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        """Drop recorded spans (post-warm-up, so the export is the trace)."""
        with self._lock:
            self._spans.clear()

    # -- export --------------------------------------------------------------

    def _records(self) -> list[dict]:
        spans = self.spans()
        t_base = min((s.t0 for s in spans), default=0.0)
        return [
            {
                "name": s.name,
                "cat": s.cat,
                "trace_id": s.trace_id,
                "ts_us": (s.t0 - t_base) * 1e6,
                "dur_us": ((s.t1 if s.t1 is not None else s.t0) - s.t0) * 1e6,
                "args": s.args,
            }
            for s in spans
        ]

    def export_jsonl(self, path) -> int:
        """One JSON span per line; returns the span count."""
        records = self._records()
        with open(path, "w", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        return len(records)

    def export_chrome(self, path) -> int:
        """Chrome trace-event format (opens directly in Perfetto)."""
        records = self._records()
        events = [
            {
                "name": rec["name"],
                "cat": rec["cat"],
                "ph": "X",
                "ts": rec["ts_us"],
                "dur": rec["dur_us"],
                "pid": 0,
                "tid": rec["trace_id"],
                "args": rec["args"],
            }
            for rec in records
        ]
        # name the tracks so Perfetto shows "request 7", not a bare tid
        tids = sorted({e["tid"] for e in events})
        events += [
            {
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {
                    "name": "server" if tid == SERVER_TRACK
                    else f"request {tid}"
                },
            }
            for tid in tids
        ]
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": events}, f)
        return len(records)


def load_trace(path) -> list[dict]:
    """Read spans back from either export format (the ``tools/trace_report``
    input path): JSON-lines, or Chrome trace JSON (metadata events
    dropped, ``X`` events mapped back to the jsonl record shape)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    stripped = text.lstrip()
    try:  # one JSON document with traceEvents = chrome format;
        # anything else (including a multi-line jsonl) falls through
        doc = json.loads(stripped)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:
        events = doc["traceEvents"]
        return [
            {
                "name": e["name"],
                "cat": e.get("cat", ""),
                "trace_id": e.get("tid", 0),
                "ts_us": e.get("ts", 0.0),
                "dur_us": e.get("dur", 0.0),
                "args": e.get("args", {}),
            }
            for e in events
            if e.get("ph") == "X"
        ]
    return [json.loads(line) for line in text.splitlines() if line.strip()]
