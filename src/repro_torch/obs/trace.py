"""Span-based tracing with JSON-lines and Chrome trace-event export.

Answers "where did this request's 40 ms go": every request through the
serving stack gets a trace id, and each stage it crosses — submit/queue
wait, batch assembly, the coalesced solve, delivery, checkpoint restores,
session updates — records one span ``(name, trace_id, t0, t1, args)``.
Each span has an ``id`` and a ``parent``: the id of the span that caused
it, 0 for a root. A span's self time is its duration less what its
children cover (``self_us``).

The solver records its phases with the same spans (``phase``):
``solver.prepare`` (partition, QR, projector, spectra, the final wait) and
``solver.solve`` (right-hand side in, substitution, the epoch loop, the
wait, the fetch), one span per phase and none per epoch. ``phase`` is the
bridge to the device trace: while ``torch.profiler`` records, it also opens
a host range of the same name over the same interval, so the profiler puts
every idle gap of the card under a program phase on its own clock. The
range is host-only: it leaves no device-side annotation, so kernel counts
and busy time read as without it. The ``Tracer``'s spans stay on
``repro_torch.obs.clock``, so ``ManualClock`` tests keep exact times.

Cost: an entry point (a ``prepare``, a ``solve``, a served batch) decides
once whether it is traced (``recorder``): off, it pays that one check and
no-op contexts; on, a few dict appends per phase, plus ~2 µs a range while
the profiler records.

Exports:

  * ``export_jsonl`` — one span per line, machine-greppable; the input
    format ``tools/trace_report.py`` summarizes.
  * ``export_chrome`` — Chrome trace-event JSON (``{"traceEvents": [...]}``,
    complete ``"ph": "X"`` events). Open the file directly in Perfetto
    (ui.perfetto.dev) or chrome://tracing: each request renders as its own
    track (``tid`` = trace id), server-side batch/pool/solver spans on
    track 0, so a serving run's queue→dispatch→solve waterfall is visible
    without any post-processing.

Both exports keep the JAX package's record shape and carry ``id`` and
``parent`` inside ``args``, so ``tools/trace_report.py`` reads either
package's exports; ``load_trace`` lifts the two back into fields.
Timestamps come from the injectable ``repro_torch.obs.clock`` (monotonic);
the exports rebase them to the earliest span so Perfetto's clock starts
near zero.
"""
from __future__ import annotations

import itertools
import json
import threading
from contextlib import contextmanager
from typing import Any

import torch

from repro_torch.obs import clock as obs_clock

SERVER_TRACK = 0  # tid for spans not owned by one request (batches, pool IO)


class Span:
    """One in-flight span; ``end()`` seals it into the tracer's buffer.

    ``trace_id`` groups spans of one logical request; ``args`` carry
    structured attributes (batch size, fingerprint, flush reason, ...);
    ``id`` is unique within the tracer and ``parent`` is the id of the span
    that caused this one (0 for a root).
    """

    __slots__ = ("tracer", "name", "cat", "trace_id", "t0", "t1", "args", "id", "parent")

    def __init__(self, tracer, name, cat, trace_id, t0, args, span_id=0, parent=0):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.t0 = t0
        self.t1 = None
        self.args = args
        self.id = span_id or tracer.new_span_id()
        self.parent = parent

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
        self._span_ids = itertools.count(1)
        self._local = threading.local()  # per thread: ids of the open phases

    def new_trace_id(self) -> int:
        return next(self._ids)

    def new_span_id(self) -> int:
        """Reserve a span id, for a span recorded later whose children
        start first (a served batch, back-filled at delivery)."""
        return next(self._span_ids)

    def begin(
        self, name: str, trace_id: int = SERVER_TRACK,
        cat: str = "serving", parent: int = 0, span_id: int = 0, **args: Any,
    ) -> Span:
        """Open a span at now(); seal it with ``span.end()``."""
        return Span(self, name, cat, trace_id, self._clock.now(), args, span_id, parent)

    def span_at(
        self, name: str, t0: float, t1: float,
        trace_id: int = SERVER_TRACK, cat: str = "serving",
        parent: int = 0, span_id: int = 0, **args: Any,
    ) -> Span:
        """Record an already-measured interval (both endpoints known) —
        how the dispatcher back-fills each request's queue span at
        dispatch time without touching the submit hot path."""
        span = Span(self, name, cat, trace_id, t0, args, span_id, parent)
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

    def _open(self) -> list:
        stack = getattr(self._local, "open", None)
        if stack is None:
            stack = self._local.open = []
        return stack

    def current(self) -> int:
        """The id of the innermost phase open on this thread (0: none)."""
        stack = self._open()
        return stack[-1] if stack else 0

    @contextmanager
    def within(self, span_id: int):
        """Make ``span_id`` the parent of the phases this thread opens
        inside the block — how a served batch, recorded on the event loop,
        parents the solve its worker thread runs."""
        stack = self._open()
        stack.append(span_id)
        try:
            yield span_id
        finally:
            stack.remove(span_id)

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
                "args": {**s.args, "id": s.id, "parent": s.parent},
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
    dropped, ``X`` events mapped back to the jsonl record shape). Each
    record also gets ``id`` and ``parent`` from its args (0 where a trace
    written before the links has none); the args keep them, so a report
    prints the same from either format."""
    return [_linked(rec) for rec in _load_records(path)]


def _linked(rec: dict) -> dict:
    args = rec.get("args") or {}
    return {**rec, "id": int(args.get("id", 0)), "parent": int(args.get("parent", 0))}


def _load_records(path) -> list[dict]:
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


def self_us(records: list[dict]) -> dict[int, float]:
    """Self time of each linked span (``load_trace`` records, or a
    tracer's ``_records()`` through ``_linked``), in µs: its duration less
    the union of its children's intervals, clipped to it."""
    records = [r if "parent" in r else _linked(r) for r in records]
    children: dict[int, list] = {}
    for r in records:
        if r["parent"]:
            children.setdefault(r["parent"], []).append(r)
    out = {}
    for r in records:
        lo, hi = r["ts_us"], r["ts_us"] + r["dur_us"]
        covered, end = 0.0, lo
        for s, e in sorted((max(lo, c["ts_us"]), min(hi, c["ts_us"] + c["dur_us"]))
                           for c in children.get(r["id"], ())):
            if e > max(s, end):
                covered += e - max(s, end)
                end = e
        out[r["id"]] = r["dur_us"] - covered
    return out


# -- phases: spans of the program's own steps, bridged to the profiler -------


def _host_range(name: str):
    """A profiler range on the host only. ``record_function`` would also
    leave a device-side annotation over the kernels it encloses, which a
    device trace reads as device activity; the fast record function is
    recorded on the host alone."""
    return torch._C._profiler._RecordFunctionFast(name)


class _Phase:
    """One phase: a ``Tracer`` span and/or a profiler range over the same
    interval. ``__enter__`` returns the span id (0 without a tracer);
    ``close()`` ends it early and is idempotent."""

    __slots__ = ("tracer", "profiling", "name", "parent", "args", "span", "range", "done")

    def __init__(self, tracer, profiling, name, parent=None, **args):
        self.tracer = tracer
        self.profiling = profiling
        self.name = name
        self.parent = parent
        self.args = args
        self.span = self.range = None
        self.done = False

    def __enter__(self) -> int:
        if self.profiling:
            self.range = _host_range(self.name)
            self.range.__enter__()
        tracer = self.tracer
        if tracer is None:
            return 0
        parent = tracer.current() if self.parent is None else self.parent
        cat = self.name.split(".", 1)[0]  # "solver", "batch"
        self.span = tracer.begin(self.name, SERVER_TRACK, cat, parent=parent, **self.args)
        tracer._open().append(self.span.id)
        return self.span.id

    def close(self) -> None:
        if self.done:
            return
        self.done = True
        if self.span is not None:
            stack = self.tracer._open()
            if self.span.id in stack:
                stack.remove(self.span.id)
            self.span.end()
        if self.range is not None:
            self.range.__exit__(None, None, None)

    def __exit__(self, *exc) -> None:
        self.close()


class _Off:
    """The phase of an untraced entry point: enters as span id 0."""

    def __enter__(self) -> int:
        return 0

    def __exit__(self, *exc) -> None:
        pass

    def close(self) -> None:
        pass


_OFF = _Off()


def untraced(name, parent=None, **args) -> _Off:
    """The phase recorder of an untraced entry point."""
    return _OFF


def profiling() -> bool:
    """Whether ``torch.profiler`` records now, on any thread: the global
    flag a profile sets when it starts (a profile of all threads records
    this thread without enabling its thread-local profiler state), or the
    thread-local state."""
    return torch.autograd.profiler._is_profiler_enabled or torch.autograd._profiler_enabled()


def recorder(tracer: Tracer | None = None):
    """Decide once, at an entry point, whether its phases are recorded:
    returns ``phase(name, parent=None, **args)`` bound to ``tracer`` and to
    whether ``torch.profiler`` records now, or a no-op when neither does.
    A phase's parent is ``parent``, else the phase open on this thread."""
    profiling_now = profiling()
    if tracer is None and not profiling_now:
        return untraced

    def phase(name, parent=None, **args) -> _Phase:
        return _Phase(tracer, profiling_now, name, parent, **args)

    return phase


def phase(tracer: Tracer | None, name: str, parent: int | None = None, **args):
    """One phase of the program: a span on ``tracer`` (if given) and, while
    ``torch.profiler`` records, a host range of the same name over the same
    interval (``recorder`` decides for a run of phases at once)."""
    return recorder(tracer)(name, parent, **args)
