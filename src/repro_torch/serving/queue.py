"""Async request-coalescing solve server over ``PreparedSolver``.

The port of the JAX package's ``repro.serving.queue``, over the port's
solvers: ``prepare``, ``Watchdog``, ``DriftPredictor`` and
``SESSION_METHODS`` are the port's, and a pooled solver solves on its own
device (the card unless the registration says ``device="cpu"``), through
the hand kernels when it was prepared with ``use_kernels=True``.

The paper's economics are many-clients/one-system: setup (per-block QR) is
amortized once per matrix, and the marginal cost of a right-hand side drops
again when several are solved as one ``(m, k)`` column batch (the consensus
update runs as (p,n)×(n,k) products per block). Real request streams do
not arrive in clean batches, so this module supplies the serving loop that
manufactures them:

  * ``SolveServer.submit(fp, b, options)`` — accept one single-RHS request
    (typed ``SubmitOptions``: priority class, deadline, per-request
    tolerance, warm start; the bare ``submit(fp, b)`` form is the
    default-options shim) and await its result;
  * a per-system dispatcher coalesces pending requests into a column batch
    under a ``BatchPolicy`` (``repro_torch.serving.policy``): bulk traffic keeps
    the throughput-oriented ``max_batch`` / ``max_wait_ms`` window, while
    INTERACTIVE requests flush in a small early batch ahead of any pending
    bulk work, deadlines pull a flush forward by the running solve-time
    estimate, and ``max_pending_bulk`` admission control keeps a bulk
    flood from starving the latency class;
  * the batch dispatches through a ``PreparedPool`` — an LRU-bounded cache
    of ``PreparedSolver``s keyed by matrix fingerprint, so factors for hot
    systems stay resident and cold ones are re-prepared on demand — and a
    pool miss consults the optional ``CheckpointStore`` first
    (``repro_torch.serving.checkpoint``), restoring persisted factors in file-IO
    time instead of re-factorizing;
  * per-column results (solution, final residual, epochs-to-tolerance via
    ``SolveResult.per_column``) scatter back to the per-request futures in
    arrival order.

Solves run on a single worker thread via ``run_in_executor`` so the event
loop keeps accepting arrivals while a batch is on the device; the single
worker serializes them. The kernels launch from that thread on its current
stream, and every ``solve`` waits for the device and returns host numpy
before the dispatcher reads the batch's completion time. The solves are
Python loops over the epochs, so the worker holds the GIL for much of a
batch, and arrivals wait for it. A kernel that fails to build or launch
raises inside the worker and enters the containment ladder like any other
solve failure; nothing here moves a solve to another device.

Fault tolerance (``repro_torch.serving.faults`` +
``repro_torch.core.guard``): a batch failure never scatters to every
batchmate — the dispatcher bisects to
isolate the poison request, a host-side ``Watchdog`` flags NaN/stalled
columns from the residual history the solve already emits, and flagged or
failing requests climb a deterministic containment ladder (retry with
exponential backoff on the injected clock → fallback re-prepare, which
keeps the registration's ``device`` and ``use_kernels`` →
checkpoint-bypassing fresh prepare → structured ``SolveFailure`` on just
the offending future), guarded by a per-system circuit breaker. A seeded
``FaultInjector`` (``faults=``) drives all of it deterministically; both
hooks are zero-cost when ``None``.

Observability (``repro_torch.obs``): every counter in this module lives in a
``MetricsRegistry`` — ``stats()`` is a dict view over it, ``render_metrics``
the Prometheus text form — and latency accounting reads ONE injectable
monotonic clock (``repro_torch.obs.clock``; pass a ``ManualClock`` for
deterministic timing tests). Pass ``tracer=`` to record per-request spans
(queue wait, coalesced solve, batch dispatch, pool prepare/restore) with
zero overhead when left ``None`` — spans are back-filled at dispatch time,
never touched on the submit hot path. A batch span runs from the take to
the end of its delivery and encloses its two children on the server track,
``batch.assemble`` (take, stack, bucket padding) and ``batch.deliver``
(per-column results, the futures); the pool's solvers carry the tracer, so
the batch's ``solver.*`` phases are its children too; both also open
profiler ranges while ``torch.profiler`` records. ``solve_ms`` stays
dispatch → results ready.
``RequestResult.worker_idle_ms`` (and the ``server_worker_idle_ms``
histogram) is how long the one worker thread sat free while a batch's
oldest request waited.
"""
from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import threading
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

from repro_torch.core import prepare
from repro_torch.core.guard import STATUS_OK, Watchdog
from repro_torch.core.prepared import ColumnResult, PreparedSolver
from repro_torch.core.session import SESSION_METHODS, DriftPredictor
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import SERVER_TRACK, Tracer, phase
from repro_torch.serving import mesh as mesh_link
from repro_torch.serving.checkpoint import CheckpointStore
from repro_torch.serving.faults import (
    FaultInjector,  # noqa: F401  (re-exported: the server's faults= hook)
    InjectedFault,
    SolveFailure,
)
from repro_torch.serving.policy import (
    AdmissionError,  # noqa: F401  (re-exported: raised by submit)
    BatchPolicy,
    Priority,
    SubmitOptions,
    batch_key,
)
from repro_torch.sparse.matrix import COOMatrix


def matrix_fingerprint(A: np.ndarray | COOMatrix) -> str:
    """Content hash identifying a system matrix across requests.

    Hashes shape + dtype + raw bytes (for a ``COOMatrix``: the coordinate
    triplets, so a sparse registration never densifies); computed once at
    ``register`` time (never per request), so the O(mn) — O(nnz) sparse —
    pass is part of the setup cost the pool amortizes, like the QR itself.
    The digest is the JAX package's for the same array or ``COOMatrix``, so
    one checkpoint directory serves both packages.
    """
    h = hashlib.sha1()
    if isinstance(A, COOMatrix):
        h.update(repr(("coo", A.shape, A.vals.dtype.str)).encode())
        for arr in (A.rows, A.cols, A.vals):
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()[:16]
    A = np.ascontiguousarray(A)
    h.update(repr((A.shape, A.dtype.str)).encode())
    h.update(A.tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class PoolStats:
    """Snapshot of the pool's registry counters (``PreparedPool.stats``
    re-derives one per access, so reads are always current). Invariant:
    ``gets == hits + prepares + restores`` — every ``get`` resolves
    exactly one way."""

    prepares: int = 0  # cache misses that ran prepare() (cold misses)
    hits: int = 0
    evictions: int = 0
    restores: int = 0  # cache misses served from the checkpoint store
    restore_ms: float = 0.0  # cumulative restore wall time
    gets: int = 0  # every pool.get call (hits + prepares + restores)


class PreparedPool:
    """LRU-bounded ``{fingerprint: PreparedSolver}`` with a side registry.

    Entries may be dense ``PreparedSolver``s or matfree
    ``MatrixFreePreparedSolver``s side by side (both honor the same
    ``solve``/``num_solves`` contract; ``resident()`` reports which path
    each pooled system took) — register with ``mode="matfree"`` or a
    sparse enough matrix under ``mode="auto"`` to get the sparse kind.
    Registering with ``mode="matfree", mesh=...`` pools the MESH-backed
    ``ShardedMatrixFreeSolver``: every coalesced batch solves on the mesh.
    When the mesh spans several ranks, this pool lives on rank 0 and
    announces each mesh-backed prepare and solve to the followers
    (``repro_torch.serving.mesh``). Mesh-backed registrations skip the
    checkpoint store and have no fallback rung.

    The registry keeps the raw (A, prepare-kwargs) per fingerprint so an
    evicted entry can be re-prepared on demand — eviction drops the
    *factors* (their device memory), never the ability to serve the
    system. Eviction only removes the pool's reference: an in-flight solve
    holds its own reference to the ``PreparedSolver``, so a batch that is
    mid-iteration when its entry is evicted finishes unharmed.

    ``checkpoint`` (a ``CheckpointStore`` or a directory path) persists
    prepared factors to disk: a miss consults the store before
    re-factorizing (``stats.restores``/``restore_ms`` count the warm
    restores), and each fresh ``prepare`` is written through, so LRU
    eviction and process restart both come back in file-IO time. A
    restore lands on the registration's ``device``.

    Thread-safe: ``get`` may run on the server's solver thread while
    ``register`` runs on the event-loop thread.
    """

    def __init__(
        self,
        max_size: int = 4,
        checkpoint: CheckpointStore | str | None = None,
        metrics: MetricsRegistry | None = None,
        clock=None,
        tracer: Tracer | None = None,
        faults=None,
        **prepare_kwargs,
    ):
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        self.max_size = max_size
        if checkpoint is not None and not isinstance(checkpoint, CheckpointStore):
            checkpoint = CheckpointStore(checkpoint, faults=faults)
        self.checkpoint = checkpoint
        self.metrics = metrics or MetricsRegistry()
        self.clock = clock or obs_clock.DEFAULT
        self.tracer = tracer
        self.faults = faults  # FaultInjector | None (None = zero cost)
        self.prepare_kwargs = dict(prepare_kwargs)
        self._systems: dict[str, tuple[np.ndarray, dict]] = {}
        self._lru: OrderedDict[str, PreparedSolver] = OrderedDict()
        self._lock = threading.Lock()
        m = self.metrics
        self._c_gets = m.counter(
            "pool_gets_total", "pool.get calls (hits + prepares + restores)"
        )
        self._c_hits = m.counter("pool_hits_total", "LRU cache hits")
        self._c_prepares = m.counter(
            "pool_prepares_total", "cold misses that ran prepare()"
        )
        self._c_restores = m.counter(
            "pool_restores_total", "misses served from the checkpoint store"
        )
        self._c_evictions = m.counter("pool_evictions_total", "LRU evictions")
        self._c_restore_ms = m.counter(
            "pool_restore_ms_total", "cumulative checkpoint restore time"
        )
        self._c_refreshes = m.counter(
            "pool_refreshes_total",
            "checkpoint-bypassing fresh prepares (recovery ladder)",
        )
        self._c_fallbacks = m.counter(
            "pool_fallbacks_total",
            "degraded-config re-prepares (recovery ladder)",
        )

    @property
    def stats(self) -> PoolStats:
        """Current counters as a ``PoolStats`` snapshot (registry-backed:
        each access re-reads, so held references are point-in-time)."""
        v = self.metrics.value
        return PoolStats(
            prepares=int(v("pool_prepares_total")),
            hits=int(v("pool_hits_total")),
            evictions=int(v("pool_evictions_total")),
            restores=int(v("pool_restores_total")),
            restore_ms=v("pool_restore_ms_total"),
            gets=int(v("pool_gets_total")),
        )

    def register(self, A: np.ndarray | COOMatrix, **prepare_kwargs) -> str:
        """Record a system for later ``get``s; returns its fingerprint.

        ``A`` may be a host ``COOMatrix`` — registered and fingerprinted
        without densifying, so a matfree-prepared system never pays the
        O(mn) dense copy at all. Idempotent — re-registering the same
        matrix returns the same fingerprint and keeps the first
        registration's kwargs.
        """
        if not isinstance(A, COOMatrix):
            A = np.asarray(A)
            if A.ndim != 2:
                raise ValueError(
                    f"expected a 2D system matrix, got shape {A.shape}"
                )
        kwargs = {**self.prepare_kwargs, **prepare_kwargs}
        fp = matrix_fingerprint(A)
        with self._lock:
            self._systems.setdefault(fp, (A, kwargs))
        return fp

    def num_rows(self, fingerprint: str) -> int:
        return self._systems[fingerprint][0].shape[0]

    def system(self, fingerprint: str) -> tuple:
        """The registered ``(A, prepare_kwargs)`` of ``fingerprint``."""
        with self._lock:
            if fingerprint not in self._systems:
                raise KeyError(
                    f"unknown system {fingerprint!r}; call register(A) first"
                )
            return self._systems[fingerprint]

    def _prepare(self, fingerprint: str, A, kwargs: dict):
        """``prepare(A, **kwargs)`` after the fault hook; a mesh-backed
        prepare is announced to the followers first."""
        if self.faults is not None:
            self.faults.on_prepare(fingerprint)
        mesh_link.announce(kwargs, "prepare", fingerprint,
                           kwargs=mesh_link.public_kwargs(kwargs))
        return prepare(A, **kwargs, tracer=self.tracer)

    def announce_solve(self, fingerprint: str, B, solve_kwargs: dict) -> None:
        """Tell the followers of a mesh-backed system to make the solve
        rank 0 makes next (nothing for a single-process system)."""
        mesh_link.announce(self.system(fingerprint)[1], "solve", fingerprint,
                           b=B, kwargs=solve_kwargs)

    def get(self, fingerprint: str) -> PreparedSolver:
        """The PreparedSolver for ``fingerprint`` — LRU hit, checkpoint
        restore, or re-prepare (in that order of preference/cost)."""
        self._c_gets.inc()
        with self._lock:
            prep = self._lru.get(fingerprint)
            if prep is not None:
                self._lru.move_to_end(fingerprint)
                self._c_hits.inc()
                return prep
            if fingerprint not in self._systems:
                raise KeyError(
                    f"unknown system {fingerprint!r}; call register(A) first"
                )
            A, kwargs = self._systems[fingerprint]
        # restore/factorize outside the lock (the expensive part)
        restore_ms = None
        prep = None
        if self.checkpoint is not None:
            t0 = self.clock.now()
            prep = self.checkpoint.load(fingerprint, kwargs)
            if prep is not None:
                if isinstance(prep, PreparedSolver):
                    prep.tracer = self.tracer
                t1 = self.clock.now()
                restore_ms = (t1 - t0) * 1e3
                if self.tracer is not None:
                    self.tracer.span_at(
                        "pool.restore", t0, t1, cat="pool",
                        fingerprint=fingerprint,
                    )
        if prep is None:
            t0 = self.clock.now()
            prep = self._prepare(fingerprint, A, kwargs)
            if self.tracer is not None:
                self.tracer.span_at(
                    "pool.prepare", t0, self.clock.now(), cat="pool",
                    fingerprint=fingerprint,
                )
            if self.checkpoint is not None:  # write-through for next miss
                self.checkpoint.save(fingerprint, prep, kwargs)
        with self._lock:
            if restore_ms is None:
                self._c_prepares.inc()
            else:
                self._c_restores.inc()
                self._c_restore_ms.inc(restore_ms)
            self._lru[fingerprint] = prep
            self._lru.move_to_end(fingerprint)
            while len(self._lru) > self.max_size:
                self._lru.popitem(last=False)
                self._c_evictions.inc()
        return prep

    # -- recovery re-prepares (the serving containment ladder) --------------

    def refresh(self, fingerprint: str) -> PreparedSolver:
        """Fresh ``prepare`` that BYPASSES the checkpoint store — the
        recovery path for factors poisoned on disk or in the pool. The new
        entry replaces the pooled one, and the write-through overwrites
        whatever checkpoint the bad restore came from."""
        with self._lock:
            if fingerprint not in self._systems:
                raise KeyError(
                    f"unknown system {fingerprint!r}; call register(A) first"
                )
            A, kwargs = self._systems[fingerprint]
        t0 = self.clock.now()
        prep = self._prepare(fingerprint, A, kwargs)
        if self.tracer is not None:
            self.tracer.span_at(
                "pool.refresh", t0, self.clock.now(), cat="pool",
                fingerprint=fingerprint,
            )
        if self.checkpoint is not None:
            self.checkpoint.save(fingerprint, prep, kwargs)
        with self._lock:
            self._c_refreshes.inc()
            self._lru[fingerprint] = prep
            self._lru.move_to_end(fingerprint)
        return prep

    @staticmethod
    def _fallback_kwargs(kwargs: dict) -> dict | None:
        """The degraded-but-sturdier prepare config one rung down the
        ladder, or None when no degrade applies: an iterative ``pcg``
        Gram solver falls back to the ``direct`` pseudo-inverse, and a
        matfree registration falls back to the dense QR path. Every other
        kwarg — ``device`` and ``use_kernels`` among them — carries over.
        Mesh-backed registrations have no single-host fallback."""
        if kwargs.get("mesh") is not None:
            return None
        if kwargs.get("gram_solver") == "pcg":
            return {**kwargs, "gram_solver": "direct"}
        if kwargs.get("mode") == "matfree":
            return {**kwargs, "mode": "dense"}
        return None

    def has_fallback(self, fingerprint: str) -> bool:
        with self._lock:
            entry = self._systems.get(fingerprint)
        return (
            entry is not None and self._fallback_kwargs(entry[1]) is not None
        )

    def fallback(self, fingerprint: str) -> PreparedSolver:
        """Re-prepare on the fallback config (``_fallback_kwargs``) and
        make it THE pooled entry: once a system needed the sturdy path,
        subsequent batches stay on it until a ``refresh``. Raises
        ``RuntimeError`` when no fallback config applies."""
        with self._lock:
            if fingerprint not in self._systems:
                raise KeyError(
                    f"unknown system {fingerprint!r}; call register(A) first"
                )
            A, kwargs = self._systems[fingerprint]
        fb = self._fallback_kwargs(kwargs)
        if fb is None:
            raise RuntimeError(
                f"no fallback prepare config for system {fingerprint!r}"
            )
        if isinstance(A, COOMatrix) and fb.get("mode") == "dense":
            A = A.to_dense()  # last-resort densify: sturdiness over memory
        t0 = self.clock.now()
        prep = self._prepare(fingerprint, A, fb)
        if self.tracer is not None:
            self.tracer.span_at(
                "pool.fallback", t0, self.clock.now(), cat="pool",
                fingerprint=fingerprint, path=prep.path,
            )
        with self._lock:
            self._c_fallbacks.inc()
            self._systems[fingerprint] = (A, fb)
            self._lru[fingerprint] = prep
            self._lru.move_to_end(fingerprint)
        if self.checkpoint is not None:
            self.checkpoint.save(fingerprint, prep, fb)
        return prep

    def resident(self) -> list[dict]:
        """Snapshot of the pooled solvers: fingerprint, execution path
        (dense/matfree), resident factor bytes, and solve count per entry
        — LRU order, coldest first (observability for the serving layer)."""
        with self._lock:
            return [
                {
                    "fingerprint": fp,
                    "path": prep.path,
                    "memory_bytes": prep.memory_bytes,
                    "num_solves": prep.num_solves,
                }
                for fp, prep in self._lru.items()
            ]

    def __contains__(self, fingerprint: str) -> bool:
        with self._lock:
            return fingerprint in self._lru

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)


@dataclasses.dataclass(frozen=True)
class RequestResult(ColumnResult):
    """What one coalesced request gets back: its ``ColumnResult`` view of
    the batch (same ``index``/``iterations``/``converged`` semantics as
    ``SolveResult.per_column`` — the serving layer adds queueing metadata,
    it does not rename the solver's result fields)."""

    batch_size: int = 0  # how many requests shared the coalesced solve
    queue_ms: float = 0.0  # enqueue → batch dispatch
    solve_ms: float = 0.0  # batch dispatch → results ready (batch-shared)
    attempts: int = 1  # solve dispatches this request rode (1 = first try)
    # the worker thread free while the batch's oldest request waited
    # (batch-shared; 0 for the first batch): start of this run − max(end
    # of the previous run, enqueue of the oldest request), at least 0
    worker_idle_ms: float = 0.0

    @property
    def column(self) -> int:
        """This request's column in the coalesced batch (= ``index``)."""
        return self.index


@dataclasses.dataclass
class ServerStats:
    """Snapshot of the dispatcher's registry counters (``SolveServer``
    re-derives one per ``stats()`` call — held references are
    point-in-time, not live)."""

    requests: int = 0
    batches: int = 0
    full_batches: int = 0  # flushed because the class's batch cap was reached
    timeout_flushes: int = 0  # flushed because the class's wait window closed
    deadline_flushes: int = 0  # pulled forward by a request deadline
    drain_flushes: int = 0  # flushed by server shutdown
    interactive_batches: int = 0
    bulk_batches: int = 0
    admission_rejects: int = 0  # bulk submits refused by max_pending_bulk
    failures: int = 0  # solve failures observed (batch-level + per-column)
    retries: int = 0  # containment ladder attempts (retry/bisect/fallback/…)
    recovered_requests: int = 0  # failed at least once, then succeeded
    failed_requests: int = 0  # futures resolved with SolveFailure
    cancelled: int = 0  # already-done (cancelled) requests dropped

    @property
    def mean_batch_size(self) -> float:
        return self.requests / self.batches if self.batches else 0.0


class _Pending:
    __slots__ = (
        "b", "future", "t_enqueue", "options", "deadline_at", "batch_key",
        "trace_id", "seq",
    )

    def __init__(self, b, future, t_enqueue, options, deadline_at,
                 trace_id=0, seq=0):
        self.b = b
        self.future = future
        self.t_enqueue = t_enqueue
        self.options = options  # SubmitOptions (x0 = session warm start)
        self.deadline_at = deadline_at  # absolute clock time, or None
        self.batch_key = batch_key(options)
        self.trace_id = trace_id  # 0 when tracing is off
        self.seq = seq  # submit-order sequence number (fault-plan target)


class _PendingQueue:
    """One system's pending requests: per-priority FIFO deques plus the
    dispatcher's wake-up event. Single-threaded (event-loop only)."""

    def __init__(self):
        self.pending = {priority: deque() for priority in Priority}
        self.event = asyncio.Event()
        self.closed = False

    def push(self, item: _Pending) -> None:
        self.pending[item.options.priority].append(item)
        self.event.set()

    def close(self) -> None:
        self.closed = True
        self.event.set()

    def empty(self) -> bool:
        return not any(self.pending.values())

    def backlog(self, priority: Priority) -> int:
        return len(self.pending[priority])

    def take(self, priority: Priority, limit: int) -> list[_Pending]:
        """Pop up to ``limit`` oldest requests of the class that share the
        head request's batch key; incompatible requests (a different
        per-request ``tol``) keep their order and go out in a later
        batch."""
        dq = self.pending[priority]
        key = dq[0].batch_key
        taken: list[_Pending] = []
        kept: list[_Pending] = []
        for item in dq:
            if len(taken) < limit and item.batch_key == key:
                taken.append(item)
            else:
                kept.append(item)
        dq.clear()
        dq.extend(kept)
        return taken


def _undispatched(assemble) -> None:
    """A batch that dispatched nothing records no batch span: its
    ``batch.assemble`` phase, if recorded, becomes a root."""
    span = getattr(assemble, "span", None)
    if span is not None:
        span.parent = 0


class SolveServer:
    """Micro-batching front end: single-RHS requests in, coalesced
    ``(m, k)`` ``PreparedSolver.solve`` calls out.

    One dispatcher task per registered system keeps batches homogeneous (a
    batch is columns against ONE matrix); requests for different systems
    queue independently and only contend for the solver thread.

    Use as an async context manager, or call ``aclose()`` when done::

        async with SolveServer(max_batch=8, max_wait_ms=2.0) as srv:
            fp = srv.register(A)
            results = await asyncio.gather(*(srv.submit(fp, b) for b in bs))

    Scheduling is delegated to a ``BatchPolicy`` (``policy=``; the legacy
    ``max_batch``/``max_wait_ms`` arguments build the default bulk-only
    policy, so existing call sites behave unchanged). ``submit`` takes an
    optional ``SubmitOptions`` for priority / deadline / per-request
    tolerance / warm start; ``checkpoint=`` threads a factor
    ``CheckpointStore`` (or directory path) into the internally-built pool.
    """

    def __init__(
        self,
        pool: PreparedPool | None = None,
        max_batch: int = 8,
        max_wait_ms: float = 2.0,
        num_epochs: int = 100,
        tol: float | None = None,
        pool_size: int = 4,
        prepare_kwargs: dict | None = None,
        solve_kwargs: dict | None = None,
        bucket_pad: bool = True,
        policy: BatchPolicy | None = None,
        checkpoint: CheckpointStore | str | None = None,
        metrics: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        clock=None,
        faults=None,
        watchdog: Watchdog | None = None,
        backoff_base_ms: float = 10.0,
        backoff_max_ms: float = 500.0,
        breaker_threshold: int = 8,
        breaker_cooldown_ms: float = 2000.0,
    ):
        """``bucket_pad=True`` pads a partial batch with zero columns up to
        ``max_batch`` so every dispatch solves at ONE width (m, max_batch).
        The port compiles nothing per width, but the consensus-update
        kernel's split-K plan (``kernels/project/ops.split_plan``) is a
        function of the shapes: at one width it is the same for every
        batch, so a column's arithmetic does not depend on how the traffic
        happened to coalesce. The consensus iteration is column-separable,
        so padding cannot perturb real columns; padded columns are dropped
        before scatter.

        ``metrics``/``tracer``/``clock`` are the observability hooks
        (``repro_torch.obs``): the registry backs every counter ``stats()``
        reports (one is created per server when omitted), the tracer —
        ``None`` = record nothing, cost nothing — gets per-request
        queue/solve spans and per-batch dispatch spans, and ``clock`` is
        THE monotonic time source for all latency accounting (defaults to
        the tracer's clock so spans and ``queue_ms`` agree, else the
        process-wide ``repro_torch.obs.clock.DEFAULT``).

        ``faults``/``watchdog`` are the fault-tolerance hooks, both
        zero-cost when ``None``: ``faults`` is a
        ``repro_torch.serving.faults.FaultInjector`` evaluated at the
        prepare/solve/checkpoint sites (threaded into an internally-built
        pool and store), and ``watchdog`` is a
        ``repro_torch.core.guard.Watchdog``
        that assesses every dispatched result host-side — unhealthy
        (NaN/stalled) columns are NOT scattered; their requests enter the
        containment ladder (retry with exponential backoff on the injected
        clock → ``gram_solver``/path fallback re-prepare →
        checkpoint-bypassing fresh prepare → structured ``SolveFailure`` on
        just the offending futures). A whole-batch failure bisects to
        isolate the poison request so innocent batchmates still succeed,
        and ``breaker_threshold`` consecutive batch failures per system
        open a circuit breaker that fast-fails new work for
        ``breaker_cooldown_ms`` (half-open trial after the cooldown)."""
        self.policy = policy or BatchPolicy(
            max_batch=int(max_batch), max_wait_ms=float(max_wait_ms)
        )
        self.max_batch = self.policy.max_batch
        self.max_wait_ms = self.policy.max_wait_ms
        self.metrics = metrics or MetricsRegistry()
        self.tracer = tracer
        if clock is None:
            clock = tracer._clock if tracer is not None else obs_clock.DEFAULT
        self.clock = clock
        self.faults = faults  # FaultInjector | None (None = zero cost)
        self.watchdog = watchdog  # guard.Watchdog | None (None = off)
        self.backoff_base_ms = float(backoff_base_ms)
        self.backoff_max_ms = float(backoff_max_ms)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_ms = float(breaker_cooldown_ms)
        self.pool = pool or PreparedPool(
            pool_size, checkpoint=checkpoint, metrics=self.metrics,
            clock=self.clock, tracer=tracer, faults=faults,
            **(prepare_kwargs or {})
        )
        self.num_epochs = int(num_epochs)
        self.tol = tol
        self.bucket_pad = bool(bucket_pad)
        self.solve_kwargs = dict(solve_kwargs or {})
        m = self.metrics
        self._c_requests = m.counter(
            "server_requests_total", "requests completed"
        )
        self._c_batches = m.counter(
            "server_batches_total", "coalesced batches dispatched"
        )
        self._c_flushes = m.counter(
            "server_flushes_total", "batch flushes by trigger reason"
        )
        self._c_class = m.counter(
            "server_class_batches_total", "batches by priority class"
        )
        self._c_rejects = m.counter(
            "server_admission_rejects_total",
            "bulk submits refused by max_pending_bulk",
        )
        self._h_queue_ms = m.histogram(
            "server_queue_ms", "enqueue to batch dispatch, per request"
        )
        self._h_solve_ms = m.histogram(
            "server_solve_ms", "batch dispatch to results ready"
        )
        self._h_batch_size = m.histogram(
            "server_batch_size", "coalesced requests per dispatched batch",
            buckets=(1, 2, 4, 8, 16, 32, 64),
        )
        self._h_worker_idle_ms = m.histogram(
            "server_worker_idle_ms",
            "worker thread free while a batch's oldest request waited, per batch",
        )
        self._g_ewma = m.gauge(
            "server_solve_ewma_seconds",
            "EWMA batch solve time (the policy's deadline estimate)",
        )
        self._g_imbalance = m.gauge(
            "server_block_imbalance",
            "slowest/fastest final per-block residual of the last solve "
            "that recorded block_history (heterogeneity signal; 1.0 = "
            "balanced decay)",
        )
        self._c_failures = m.counter(
            "server_failures_total", "solve failures observed, by reason"
        )
        self._c_retries = m.counter(
            "server_retries_total", "containment ladder attempts, by stage"
        )
        self._c_recovered = m.counter(
            "server_recovered_requests_total",
            "requests that failed at least once, then succeeded",
        )
        self._c_failed = m.counter(
            "server_failed_requests_total",
            "futures resolved with a structured SolveFailure",
        )
        self._c_cancelled = m.counter(
            "server_cancelled_total",
            "already-done (cancelled) requests dropped at dispatch",
        )
        self._c_breaker = m.counter(
            "server_breaker_transitions_total",
            "circuit breaker transitions, by target state",
        )
        self._queues: dict[str, _PendingQueue] = {}
        self._dispatchers: dict[str, asyncio.Task] = {}
        self._solve_s: dict[str, float] = {}  # EWMA batch solve time
        self._seq = 0  # submit-order request counter (fault-plan targets)
        # per-fingerprint circuit breaker: consecutive NORMAL-dispatch
        # failures trip it open; recovery-ladder attempts never count
        # (they are already contained)
        self._breaker: dict[str, dict] = {}
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="solve"
        )
        # end of the last run; read and written on the worker thread only
        self._worker_free_at: float | None = None
        self._closed = False

    # -- lifecycle ----------------------------------------------------------

    async def __aenter__(self) -> "SolveServer":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    async def aclose(self) -> None:
        """Drain dispatchers (pending requests still complete) and shut down."""
        self._closed = True
        for q in self._queues.values():
            q.close()
        for task in self._dispatchers.values():
            await task
        self._executor.shutdown(wait=True)

    # -- observability ------------------------------------------------------

    @property
    def _stats(self) -> ServerStats:
        """Registry-backed dispatcher-counter snapshot (see ``stats()``)."""
        v = self.metrics.value
        return ServerStats(
            requests=int(v("server_requests_total")),
            batches=int(v("server_batches_total")),
            full_batches=int(v("server_flushes_total", reason="full")),
            timeout_flushes=int(v("server_flushes_total", reason="timeout")),
            deadline_flushes=int(
                v("server_flushes_total", reason="deadline")
            ),
            drain_flushes=int(v("server_flushes_total", reason="drain")),
            interactive_batches=int(
                v("server_class_batches_total", priority="interactive")
            ),
            bulk_batches=int(v("server_class_batches_total", priority="bulk")),
            admission_rejects=int(v("server_admission_rejects_total")),
            # failures/retries are labeled by reason/stage: read the
            # cross-label aggregate, not one series
            failures=int(self.metrics.total("server_failures_total")),
            retries=int(self.metrics.total("server_retries_total")),
            recovered_requests=int(v("server_recovered_requests_total")),
            failed_requests=int(v("server_failed_requests_total")),
            cancelled=int(v("server_cancelled_total")),
        )

    def stats(self) -> dict:
        """The unified serving-stats view: dispatcher counters (requests,
        batches, flush reasons, per-class batches, admission rejects) merged
        flat with the pool's cache counters — gets / hits / misses
        (prepares + restores) / evictions — and the checkpoint restore
        metrics (``restores``, ``restore_ms``). Every value is a view over
        the ``MetricsRegistry`` (``self.metrics``) — the same numbers
        ``render_metrics`` exposes to a Prometheus scraper."""
        snap = self._stats
        out = dataclasses.asdict(snap)
        out["mean_batch_size"] = snap.mean_batch_size
        pool = self.pool.stats
        out.update(dataclasses.asdict(pool))
        out["misses"] = pool.prepares + pool.restores
        out["block_imbalance"] = float(
            self.metrics.value("server_block_imbalance")
        )
        return out

    def reset_stats(self) -> None:
        """Zero the dispatcher counters (e.g. after warm-up, so a measured
        trace reports itself). Pool/checkpoint counters are cumulative; the
        EWMA solve-time gauge survives too (it is a policy input, not a
        trace counter)."""
        for name in (
            "server_requests_total", "server_batches_total",
            "server_flushes_total", "server_class_batches_total",
            "server_admission_rejects_total", "server_queue_ms",
            "server_solve_ms", "server_batch_size", "server_worker_idle_ms",
            "server_failures_total", "server_retries_total",
            "server_recovered_requests_total",
            "server_failed_requests_total", "server_cancelled_total",
        ):
            metric = self.metrics.get(name)
            if metric is not None:
                metric.reset()

    def render_metrics(self) -> str:
        """The Prometheus text exposition of this server's registry (serve
        it with ``repro_torch.obs.metrics.start_exposition(server.metrics)``)."""
        return self.metrics.render()

    # -- request path -------------------------------------------------------

    def register(self, A: np.ndarray, **prepare_kwargs) -> str:
        """Register a system matrix; returns the fingerprint to submit with."""
        return self.pool.register(A, **prepare_kwargs)

    async def submit(
        self,
        fingerprint: str,
        b: np.ndarray,
        options: SubmitOptions | None = None,
    ) -> RequestResult:
        """Submit one right-hand side; resolves when its batch completes.

        ``options`` is the typed request surface (``SubmitOptions``):
        priority class, deadline, per-request tolerance, warm start. The
        bare two-argument form is the default-options shim — bulk priority,
        no deadline, i.e. exactly the historical FIFO behavior. Raises
        ``AdmissionError`` synchronously when admission control refuses a
        bulk request (``BatchPolicy.max_pending_bulk``).
        """
        return await self._enqueue(fingerprint, b, options)

    def open_session(
        self, fingerprint: str, predict: str = "auto"
    ) -> "ServerSession":
        """Open a prediction-correction stream against one registered
        system (see ``repro_torch.core.session``): each ``await session.update(b)``
        rides the ordinary coalescing dispatcher — the session's column
        batches alongside one-shot ``submit`` columns, carrying its warm
        start with it. Session state lives entirely client-side in the
        handle (keyed by fingerprint, not by pool entry), so LRU eviction
        and re-prepare of the underlying solver are invisible to a stream
        in flight."""
        self.pool.num_rows(fingerprint)  # KeyError for unknown systems
        return ServerSession(self, fingerprint, predict=predict)

    async def _enqueue(
        self,
        fingerprint: str,
        b: np.ndarray,
        options: SubmitOptions | None = None,
        trace_id: int | None = None,
    ) -> RequestResult:
        if self._closed:
            raise RuntimeError("server is closed")
        options = options or SubmitOptions()
        b = np.asarray(b)
        m = self.pool.num_rows(fingerprint)  # KeyError for unknown systems
        if b.shape != (m,):
            raise ValueError(f"rhs shape {b.shape} != ({m},) for this system")
        loop = asyncio.get_running_loop()
        queue = self._queues.get(fingerprint)
        if queue is None:
            queue = self._queues[fingerprint] = _PendingQueue()
            self._dispatchers[fingerprint] = asyncio.create_task(
                self._dispatch_loop(fingerprint, queue)
            )
        try:  # admission control: fail fast BEFORE the request queues
            self.policy.admit(options.priority, queue.backlog(Priority.BULK))
        except AdmissionError:
            self._c_rejects.inc()
            raise
        if not self._breaker_allows(fingerprint):
            # open circuit: fail fast instead of queueing work the system
            # is currently failing — the half-open trial after the
            # cooldown is what probes recovery
            self._c_failures.labels(reason="breaker_open").inc()
            self._c_failed.inc()
            raise SolveFailure(
                fingerprint, "breaker_open", attempts=0, request=self._seq
            )
        if trace_id is None:
            trace_id = (
                self.tracer.new_trace_id() if self.tracer is not None else 0
            )
        future: asyncio.Future = loop.create_future()
        now = self.clock.now()
        deadline_at = (
            None if options.deadline_ms is None
            else now + options.deadline_ms / 1e3
        )
        seq = self._seq
        self._seq += 1
        queue.push(
            _Pending(b, future, now, options, deadline_at, trace_id, seq)
        )
        return await future

    @property
    def next_request_seq(self) -> int:
        """The seq the NEXT submit will get — lets a fault plan target
        absolute request indices relative to warm-up traffic."""
        return self._seq

    # -- batching loop ------------------------------------------------------

    async def _dispatch_loop(self, fingerprint: str, queue: _PendingQueue):
        """One system's scheduler: wait for work, ask the ``BatchPolicy``
        which class to flush (or when to wake), dispatch, repeat. Strictly
        interactive-first by construction of ``BatchPolicy.decide``; on
        close the queue drains — pending requests still complete."""
        while True:
            if queue.empty():
                if queue.closed:
                    return
                await queue.event.wait()
                queue.event.clear()
                continue
            priority, reason, wake = self.policy.decide(
                self.clock.now(), queue.pending,
                solve_s=self._solve_s.get(fingerprint, 0.0),
                draining=queue.closed,
            )
            if priority is None:  # sleep until the decision can change
                try:
                    await asyncio.wait_for(
                        queue.event.wait(),
                        max(0.0, wake - self.clock.now()),
                    )
                    queue.event.clear()
                except asyncio.TimeoutError:
                    pass
                continue
            # the batch's span id, reserved: its children start before it
            # is recorded; assembly runs on, without an await, to the
            # hand-off in _attempt
            batch_id = self.tracer.new_span_id() if self.tracer is not None else 0
            t_begin = self.clock.now()
            assemble = phase(self.tracer, "batch.assemble", parent=batch_id)
            try:
                assemble.__enter__()
                batch = queue.take(priority, self.policy.cap(priority))
                self._c_flushes.labels(reason=reason).inc()
                self._c_class.labels(priority=priority.name.lower()).inc()
                await self._solve_batch(fingerprint, batch, reason, priority,
                                        batch_id=batch_id, assemble=assemble,
                                        t_begin=t_begin)
            finally:
                assemble.close()

    # -- fault containment --------------------------------------------------

    def _breaker_allows(self, fingerprint: str) -> bool:
        """True iff dispatch/submit may proceed (closed or half-open)."""
        st = self._breaker.get(fingerprint)
        if st is None or st["state"] == "closed":
            return True
        if st["state"] == "open":
            if self.clock.now() < st["open_until"]:
                return False
            st["state"] = "half_open"  # cooldown over: admit a trial
            self._c_breaker.labels(to="half_open").inc()
            if self.tracer is not None:
                t = self.clock.now()
                self.tracer.span_at(
                    "breaker.half_open", t, t, trace_id=SERVER_TRACK,
                    cat="fault", fingerprint=fingerprint,
                )
        return True  # half_open: let the trial through

    def _breaker_record(self, fingerprint: str, ok: bool) -> None:
        """Feed a NORMAL-dispatch outcome into the per-system breaker.
        Recovery-ladder attempts never call this — they are contained."""
        st = self._breaker.setdefault(
            fingerprint, {"state": "closed", "consec": 0, "open_until": 0.0}
        )
        if ok:
            if st["state"] != "closed":
                self._c_breaker.labels(to="closed").inc()
                if self.tracer is not None:
                    t = self.clock.now()
                    self.tracer.span_at(
                        "breaker.closed", t, t, trace_id=SERVER_TRACK,
                        cat="fault", fingerprint=fingerprint,
                    )
            st["state"], st["consec"] = "closed", 0
            return
        st["consec"] += 1
        trip = st["state"] == "half_open" or (
            st["state"] == "closed" and st["consec"] >= self.breaker_threshold
        )
        if trip:
            st["state"] = "open"
            st["open_until"] = (
                self.clock.now() + self.breaker_cooldown_ms / 1e3
            )
            self._c_breaker.labels(to="open").inc()
            if self.tracer is not None:
                t = self.clock.now()
                self.tracer.span_at(
                    "breaker.open", t, t, trace_id=SERVER_TRACK,
                    cat="fault", fingerprint=fingerprint,
                    consecutive_failures=st["consec"],
                )

    @staticmethod
    def _failure_reason(exc: BaseException) -> str:
        if isinstance(exc, InjectedFault):
            return exc.kind if exc.kind in ("nan", "stall") else "error"
        return "error"

    def _expired(self, pending: _Pending) -> bool:
        t = pending.options.timeout_ms
        return (
            t is not None
            and (self.clock.now() - pending.t_enqueue) >= t / 1e3
        )

    def _fail_request(
        self,
        fingerprint: str,
        pending: _Pending,
        reason: str,
        attempts: int,
        cause: BaseException | None = None,
    ) -> None:
        """Resolve ONE future with a structured ``SolveFailure``."""
        self._c_failed.inc()
        if self.tracer is not None:
            t = self.clock.now()
            self.tracer.span_at(
                "fail", t, t, trace_id=pending.trace_id, cat="fault",
                fingerprint=fingerprint, reason=reason, attempts=attempts,
            )
        if not pending.future.done():
            pending.future.set_exception(
                SolveFailure(
                    fingerprint, reason, attempts=attempts,
                    request=pending.seq, cause=cause,
                )
            )

    async def _backoff(self, attempt: int) -> float:
        """Exponential backoff between ladder attempts, on the INJECTED
        clock: a ``ManualClock`` advances (deterministic tests — no real
        sleeping), a real clock sleeps on the event loop."""
        delay = (
            min(self.backoff_base_ms * (2.0 ** attempt), self.backoff_max_ms)
            / 1e3
        )
        if hasattr(self.clock, "advance"):
            self.clock.advance(delay)
        else:
            await asyncio.sleep(delay)
        return delay

    def _sick_columns(self, result, nbatch: int, tol) -> dict[int, str]:
        """Watchdog verdicts for the REAL (non-padded) batch columns:
        ``{batch_index: status}`` for every unhealthy column. ``{}`` when
        the watchdog is off — zero work, the unguarded server's behavior."""
        if self.watchdog is None:
            return {}
        try:
            health = self.watchdog.assess(result, tol=tol)
        except ValueError:  # method without a residual history (cgnr/dgd)
            return {}
        return {
            i: health.status[i]
            for i in range(min(nbatch, len(health.status)))
            if health.status[i] != STATUS_OK
        }

    async def _solve_batch(
        self,
        fingerprint: str,
        batch: list[_Pending],
        reason: str = "full",
        priority: Priority = Priority.BULK,
        batch_id: int = 0,
        assemble=None,
        t_begin: float | None = None,
    ):
        """Contained dispatch: solve the batch; on failure, isolate and
        recover instead of scattering the exception batch-wide.
        ``batch_id`` is the batch span's reserved id (0: reserve one),
        ``assemble`` the open ``batch.assemble`` phase, closed at hand-off,
        and ``t_begin`` the batch span's start (None: now), so the span
        encloses the assembly, the solve and the delivery.

        * Requests whose futures are already done (caller cancelled) are
          dropped up front — a dead request never occupies a column, and
          can neither poison nor stall its batchmates.
        * Expired ``timeout_ms`` budgets and an open circuit breaker fail
          their requests fast with ``SolveFailure`` before any solve.
        * A whole-batch exception bisects: each half redispatches through
          this same path, so the poison request is isolated in O(log k)
          extra solves while innocent batchmates succeed on the way.
        * A singleton failure — or a watchdog-flagged NaN/stalled column
          in an otherwise healthy batch — enters the ``_recover`` ladder.

        The dispatcher task survives every path, or pending submits hang.
        """
        if t_begin is None:
            t_begin = self.clock.now()
        alive = [p for p in batch if not p.future.done()]
        if len(alive) < len(batch):
            self._c_cancelled.inc(len(batch) - len(alive))
        batch = alive
        live: list[_Pending] = []
        for p in batch:
            if self._expired(p):
                self._c_failures.labels(reason="timeout").inc()
                self._fail_request(fingerprint, p, "timeout", attempts=0)
            else:
                live.append(p)
        if not live:
            _undispatched(assemble)
            return
        if not self._breaker_allows(fingerprint):
            for p in live:
                self._c_failures.labels(reason="breaker_open").inc()
                self._fail_request(
                    fingerprint, p, "breaker_open", attempts=0
                )
            _undispatched(assemble)
            return
        if self.tracer is not None and not batch_id:
            batch_id = self.tracer.new_span_id()
        try:
            result, tol, t0, t1, idle_ms = await self._attempt(
                fingerprint, live, batch_id=batch_id, assemble=assemble
            )
        except Exception as exc:
            self._c_failures.labels(reason=self._failure_reason(exc)).inc()
            self._breaker_record(fingerprint, ok=False)
            if assemble is not None:  # a failure before the hand-off
                assemble.close()
            if self.tracer is not None:
                self.tracer.span_at(
                    "batch", t_begin, self.clock.now(),
                    trace_id=SERVER_TRACK, cat="server", span_id=batch_id,
                    fingerprint=fingerprint, batch_size=len(live),
                    reason=reason, priority=priority.name.lower(),
                    error=repr(exc),
                )
            if len(live) == 1:
                await self._recover(
                    fingerprint, live[0], self._failure_reason(exc), exc,
                    priority,
                )
                return
            # bisect: innocent batchmates retry (and succeed) in halves;
            # the poison request funnels down to a singleton recovery
            mid = len(live) // 2
            self._c_retries.labels(stage="bisect").inc()
            for half in (live[:mid], live[mid:]):
                await self._solve_batch(
                    fingerprint, half, "bisect", priority
                )
            return
        sick = self._sick_columns(result, len(live), tol)
        self._breaker_record(fingerprint, ok=True)
        self._deliver(
            fingerprint, live, result, tol, t0, t1, reason, priority,
            skip=frozenset(sick), worker_idle_ms=idle_ms, batch_id=batch_id,
            t_begin=t_begin,
        )
        for i, status in sick.items():
            self._c_failures.labels(reason=status).inc()
            await self._recover(
                fingerprint, live[i], status, None, priority
            )

    async def _attempt(
        self,
        fingerprint: str,
        batch: list[_Pending],
        prep_source: str = "pool",
        batch_id: int = 0,
        assemble=None,
    ):
        """ONE coalesced solve on the worker thread. Returns ``(result, tol,
        t_dispatch, t_done, worker_idle_ms)``; raises on any failure
        (including injected ones). ``prep_source`` picks the ladder rung:
        ``"pool"`` (normal get), ``"fallback"`` (degraded re-prepare), or
        ``"refresh"`` (checkpoint-bypassing fresh prepare). The solve's
        phases are children of span ``batch_id``; ``assemble``, the batch's
        open ``batch.assemble`` phase, closes at the hand-off to the
        worker."""
        loop = asyncio.get_running_loop()
        t_dispatch = self.clock.now()
        # the batch shares one batch key (``_PendingQueue.take`` groups on
        # it), so per-request solve options are batch-uniform here
        tol = batch[0].options.tol
        tol = self.tol if tol is None else tol
        B = np.stack([p.b for p in batch], axis=1)  # (m, k), arrival order
        if self.bucket_pad and B.shape[1] < self.max_batch:
            pad = np.zeros((B.shape[0], self.max_batch - B.shape[1]), B.dtype)
            B = np.concatenate([B, pad], axis=1)
        # session columns carry a warm start; the masked (x0, mask) operand
        # lets them batch alongside cold one-shot columns in ONE solve
        # (masked-off columns reduce exactly to the plain init)
        x0_arg = None
        if any(p.options.x0 is not None for p in batch):
            n = next(
                p.options.x0 for p in batch if p.options.x0 is not None
            ).shape[0]
            k = B.shape[1]  # after bucket padding; padded columns stay cold
            warm = np.zeros((n, k), B.dtype)
            mask = np.zeros((k,), bool)
            for i, p in enumerate(batch):
                if p.options.x0 is not None:
                    warm[:, i] = p.options.x0
                    mask[i] = True
            x0_arg = (warm, mask)
        seqs = tuple(p.seq for p in batch)
        t_oldest = min(p.t_enqueue for p in batch)
        idle = {}

        def run():
            t_run = self.clock.now()
            free_at = self._worker_free_at
            idle["ms"] = 0.0 if free_at is None else max(
                0.0, (t_run - max(free_at, t_oldest)) * 1e3)
            try:
                if self.tracer is None:
                    return solve()
                with self.tracer.within(batch_id):
                    return solve()
            finally:
                self._worker_free_at = self.clock.now()

        def solve():
            # pool access inside the solver thread: a cache miss (or a
            # ladder re-prepare) factorizes there, and the local reference
            # keeps the factors alive even if the pool evicts mid-solve
            if prep_source == "fallback":
                prep = self.pool.fallback(fingerprint)
            elif prep_source == "refresh":
                prep = self.pool.refresh(fingerprint)
            else:
                prep = self.pool.get(fingerprint)
            actions = {}
            if self.faults is not None:
                actions = self.faults.on_solve(
                    fingerprint, seqs, path=getattr(prep, "path", None)
                )
            kwargs = dict(self.solve_kwargs)
            if tol is not None and prep.method in SESSION_METHODS:
                # arm the masked in-scan early exit at the reporting
                # tolerance: converged (and zero-padded bucket) columns
                # freeze instead of burning projector work to the epoch cap
                kwargs.setdefault("tol", tol)
            if x0_arg is not None and prep.method in SESSION_METHODS:
                # the projection warm start is consensus-only; on other
                # methods the prediction is silently dropped (cold solve)
                kwargs["x0"] = x0_arg
            if kwargs.get("block_history") and prep.method not in SESSION_METHODS:
                # per-block diagnostics are consensus-only (cgnr/dgd have no
                # block decomposition to attribute residuals to)
                kwargs.pop("block_history")
            # the followers of a mesh-backed system make the same solve
            self.pool.announce_solve(
                fingerprint, B, {"num_epochs": self.num_epochs, **kwargs}
            )
            result = prep.solve(B, num_epochs=self.num_epochs, **kwargs)
            if actions and self.faults is not None:
                cols = {s: i for i, s in enumerate(seqs)}
                result = self.faults.corrupt_result(
                    result, actions,
                    {s: cols[s] for s in actions if s in cols},
                )
            return result

        if assemble is not None:
            assemble.close()
        result = await loop.run_in_executor(self._executor, run)
        t_done = self.clock.now()
        trace = result.history.get("block_residual_sq")
        if trace is not None:
            # heterogeneity gauge: how unevenly the blocks finished — the
            # partitioner-facing signal behind repro_torch.obs.convergence
            final = np.asarray(trace[-1])  # (J,) or (J, k)
            if final.ndim > 1:
                final = final.sum(axis=-1)
            self._g_imbalance.set(
                float(final.max() / max(float(final.min()), 1e-30))
            )
        return result, tol, t_dispatch, t_done, idle["ms"]

    def _deliver(
        self,
        fingerprint: str,
        batch: list[_Pending],
        result,
        tol,
        t_dispatch: float,
        t_done: float,
        reason: str,
        priority: Priority,
        attempts: int = 1,
        skip: frozenset = frozenset(),
        worker_idle_ms: float = 0.0,
        batch_id: int = 0,
        t_begin: float | None = None,
    ) -> None:
        """Split ``result`` per column and scatter it to the batch's futures
        (skipping the watchdog-flagged indices in ``skip`` — those recover
        separately), and record the batch's metrics/spans: the batch span
        under the reserved ``batch_id``, from ``t_begin`` (None:
        ``t_dispatch``) to the end of this delivery, which is its
        ``batch.deliver`` child."""
        tracer = self.tracer
        batch_span = None
        if tracer is not None:
            # one span per batch on the server track, plus the back-filled
            # per-request queue + solve spans — each request's track shows
            # its whole enqueue → dispatch → result timeline. Sealed first,
            # in the reference's record order; it ends with the delivery.
            batch_span = tracer.span_at(
                "batch", t_dispatch if t_begin is None else t_begin, t_done,
                trace_id=SERVER_TRACK, cat="server", span_id=batch_id,
                fingerprint=fingerprint, batch_size=len(batch), reason=reason,
                priority=priority.name.lower(),
            )
        with phase(tracer, "batch.deliver", parent=batch_id):
            columns = result.per_column(tol=tol)
            solve_ms = (t_done - t_dispatch) * 1e3
            # EWMA batch solve time — what the policy's deadline pull-forward
            # assumes the NEXT batch will cost
            prev = self._solve_s.get(fingerprint)
            dt = solve_ms / 1e3
            self._solve_s[fingerprint] = (
                dt if prev is None else 0.7 * prev + 0.3 * dt
            )
            self._g_ewma.set(self._solve_s[fingerprint])
            delivered = len(batch) - len(skip)
            self._c_requests.inc(delivered)
            self._c_batches.inc()
            self._h_solve_ms.observe(solve_ms)
            self._h_batch_size.observe(len(batch))
            self._h_worker_idle_ms.observe(worker_idle_ms)
            for i, (pending, col) in enumerate(zip(batch, columns)):
                if i in skip:
                    continue
                queue_ms = (t_dispatch - pending.t_enqueue) * 1e3
                self._h_queue_ms.observe(queue_ms)
                if tracer is not None:
                    tracer.span_at(
                        "queue", pending.t_enqueue, t_dispatch,
                        trace_id=pending.trace_id, cat="request",
                        priority=pending.options.priority.name.lower(),
                    )
                    tracer.span_at(
                        "solve", t_dispatch, t_done,
                        trace_id=pending.trace_id, cat="request",
                        fingerprint=fingerprint, column=i,
                        batch_size=len(batch),
                        iterations=int(col.iterations),
                        converged=bool(col.converged),
                    )
                if pending.future.done():  # caller went away (cancelled)
                    self._c_cancelled.inc()
                    continue
                pending.future.set_result(
                    RequestResult(
                        # widen the ColumnResult into the serving shape (no
                        # asdict: that would deep-copy the solution vector)
                        **{f.name: getattr(col, f.name)
                           for f in dataclasses.fields(col)},
                        batch_size=len(batch),
                        queue_ms=queue_ms,
                        solve_ms=solve_ms,
                        attempts=attempts,
                        worker_idle_ms=worker_idle_ms,
                    )
                )
        if batch_span is not None:
            batch_span.t1 = self.clock.now()

    async def _recover(
        self,
        fingerprint: str,
        pending: _Pending,
        reason: str,
        cause: BaseException | None,
        priority: Priority,
    ) -> None:
        """The single-request containment ladder, in escalation order:

            retry × ``max_retries`` → fallback re-prepare (``gram_solver``
            pcg→direct, or matfree→dense) → checkpoint-bypassing fresh
            prepare → structured ``SolveFailure``

        Exponential backoff (on the injected clock) precedes every rung;
        the ``timeout_ms`` budget is re-checked between rungs, so a slow
        ladder converts into a clean timeout rather than unbounded work.
        Every attempt is a metric (``server_retries_total{stage=}``) and a
        trace span; a success counts ``server_recovered_requests_total``
        and delivers a normal ``RequestResult`` (with its ``attempts``)."""
        stages = ["retry"] * max(0, int(pending.options.max_retries))
        if self.pool.has_fallback(fingerprint):
            stages.append("fallback")
        stages.append("refresh")
        last_reason, last_exc = reason, cause
        attempts = 1  # the failed original dispatch
        for stage in stages:
            if pending.future.done():
                self._c_cancelled.inc()
                return
            await self._backoff(attempts - 1)
            if self._expired(pending):
                self._c_failures.labels(reason="timeout").inc()
                self._fail_request(
                    fingerprint, pending, "timeout", attempts, last_exc
                )
                return
            attempts += 1
            self._c_retries.labels(stage=stage).inc()
            t_stage = self.clock.now()
            prep_source = "pool" if stage == "retry" else stage
            batch_id = self.tracer.new_span_id() if self.tracer is not None else 0
            try:
                result, tol, t0, t1, idle_ms = await self._attempt(
                    fingerprint, [pending], prep_source=prep_source,
                    batch_id=batch_id,
                )
            except Exception as exc:
                last_reason, last_exc = self._failure_reason(exc), exc
                self._c_failures.labels(reason=last_reason).inc()
                if self.tracer is not None:  # the attempt's span: its solve's parent
                    self.tracer.span_at(
                        f"recover.{stage}", t_stage, self.clock.now(),
                        trace_id=pending.trace_id, cat="fault", span_id=batch_id,
                        fingerprint=fingerprint, error=repr(exc),
                    )
                continue
            sick = self._sick_columns(result, 1, tol)
            if sick:
                last_reason, last_exc = sick[0], None
                self._c_failures.labels(reason=last_reason).inc()
                if self.tracer is not None:
                    self.tracer.span_at(
                        f"recover.{stage}", t_stage, self.clock.now(),
                        trace_id=pending.trace_id, cat="fault", span_id=batch_id,
                        fingerprint=fingerprint, status=last_reason,
                    )
                continue
            self._c_recovered.inc()
            if self.tracer is not None:
                self.tracer.span_at(
                    f"recover.{stage}", t_stage, self.clock.now(),
                    trace_id=pending.trace_id, cat="fault",
                    fingerprint=fingerprint, recovered=True,
                )
            self._deliver(
                fingerprint, [pending], result, tol, t0, t1,
                f"recover_{stage}", priority, attempts=attempts,
                worker_idle_ms=idle_ms, batch_id=batch_id, t_begin=t_stage,
            )
            return
        self._fail_request(
            fingerprint, pending, last_reason, attempts, last_exc
        )


class ServerSession:
    """One prediction-correction stream over a ``SolveServer`` system.

    The server-side twin of ``repro_torch.core.session.Session``: it holds the
    same ``DriftPredictor`` (identical predict semantics — extrapolate
    from the RHS drift, warm-start fallback, ``predict="none"`` for cold
    baselines) but corrects through the coalescing dispatcher instead of
    a private solve — each ``await update(b_t)`` enqueues one column that
    batches alongside ordinary ``submit`` traffic, with the prediction
    attached per column. All stream state lives in this handle: the pool
    may evict and re-prepare the underlying solver between updates (or a
    different replica may serve the next batch) without perturbing the
    stream, because the warm start travels with the request.

    Not safe for concurrent ``update`` calls on one session — a stream is
    ordered by definition (x_{t} feeds the t+1 prediction). Open one
    session per stream; many sessions coalesce happily.
    """

    def __init__(self, server: SolveServer, fingerprint: str,
                 predict: str = "auto"):
        self.server = server
        self.fingerprint = fingerprint
        self._predictor = DriftPredictor(predict)
        self._updates = 0
        self._total_iterations = 0

    @property
    def num_updates(self) -> int:
        return self._updates

    @property
    def total_iterations(self) -> int:
        """Cumulative reported epochs across the stream's updates — the
        serving-side analogue of ``Session.total_epochs``."""
        return self._total_iterations

    def reset(self) -> None:
        """Forget the stream history; the next update solves cold."""
        self._predictor.reset()

    async def update(
        self, b: np.ndarray, options: SubmitOptions | None = None
    ) -> RequestResult:
        """Predict from the stream history, enqueue the corrected solve,
        observe the result. Resolves when the carrying batch completes.

        ``options`` carries the same typed surface as ``submit`` (priority,
        deadline, tolerance); the stream's prediction rides its ``x0`` slot
        unless the caller pinned an explicit warm start there. With the
        server tracing, the update's ``session.update`` span shares the
        request's trace id, so the prediction overhead and the carried
        solve render on one track."""
        b = np.asarray(b)
        options = options or SubmitOptions()
        tracer = self.server.tracer
        trace_id = tracer.new_trace_id() if tracer is not None else None
        t0 = self.server.clock.now()
        if options.x0 is None:
            x0 = self._predictor.predict(b)
            if x0 is not None:
                options = dataclasses.replace(options, x0=x0)
        res = await self.server._enqueue(
            self.fingerprint, b, options, trace_id=trace_id
        )
        self._predictor.observe(b, res.x)
        self._updates += 1
        self._total_iterations += int(res.iterations)
        if tracer is not None:
            tracer.span_at(
                "session.update", t0, self.server.clock.now(),
                trace_id=trace_id, cat="session",
                update=self._updates, warm=options.x0 is not None,
            )
        return res


async def replay_trace(
    server: SolveServer,
    fingerprint: str,
    rhs: np.ndarray,  # (m, k) — column i is request i's b
    gaps_s: Any,  # iterable of k inter-arrival gaps in seconds (first may be 0)
    *,
    return_exceptions: bool = False,
) -> list[RequestResult]:
    """Replay an arrival trace: request i fires after ``sum(gaps_s[:i+1])``.

    Results come back indexed by REQUEST (not completion) order, so callers
    can check each response against the right-hand side that produced it.
    With ``return_exceptions=True`` a request that fails structurally keeps
    its slot as the raised ``SolveFailure`` instead of aborting the replay
    (how the CLI runs a --fault-plan trace to completion).
    Used by ``repro_torch.launch.serve_solver``.
    """

    async def client(i: int, delay: float):
        await asyncio.sleep(delay)
        return await server.submit(fingerprint, rhs[:, i])

    arrival, tasks = 0.0, []
    for i, gap in enumerate(gaps_s):
        arrival += float(gap)
        tasks.append(asyncio.create_task(client(i, arrival)))
    return list(await asyncio.gather(*tasks, return_exceptions=return_exceptions))
