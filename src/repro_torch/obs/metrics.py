"""Process-local metrics registry: counters / gauges / histograms with
labels, plus a Prometheus-style text exposition.

Deliberately dependency-free and small: the serving stack needs counter
bumps on the request path (so an increment is one dict lookup + add under
one lock, no per-sample allocation beyond the first) and a way to READ
them — both as plain python values (``SolveServer.stats()`` builds its
dict view straight off the registry) and as the standard text format any
Prometheus scraper ingests (``MetricsRegistry.render`` /
``start_exposition``).

Each ``SolveServer``/``PreparedPool`` owns its registry by default so
concurrent servers in one process (tests, benchmarks) never share
counters; pass a registry in to aggregate across components instead.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# histogram defaults tuned for the serving stack's ms-scale latencies
DEFAULT_MS_BUCKETS = (
    0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
)


def _format_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    """One named metric family; ``labels(**kv)`` returns (and memoizes) the
    child series for that label set. A label-less family is its own sole
    child, so ``metric.inc()`` / ``metric.value`` work directly."""

    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._registry = registry
        self._series: dict[tuple, dict] = {}

    def _lock(self):
        return self._registry._lock

    def labels(self, **labelvalues) -> "_Series":
        key = tuple(sorted(labelvalues.items()))
        with self._lock():
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = self._new_state()
        return _Series(self, key, state)

    def _new_state(self) -> dict:
        return {"value": 0.0}

    # -- label-less convenience (delegates to the empty-label series) -------

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    @property
    def value(self) -> float:
        return self.labels().value

    def reset(self) -> None:
        """Zero every series of this family (post-warm-up accounting)."""
        with self._lock():
            for key in self._series:
                self._series[key] = self._new_state()

    def collect(self) -> list[tuple[dict, dict]]:
        """Snapshot: ``[(labels_dict, state_dict), ...]``."""
        with self._lock():
            return [
                (dict(key), {k: (dict(v) if isinstance(v, dict) else v)
                             for k, v in state.items()})
                for key, state in self._series.items()
            ]


class Counter(_Metric):
    kind = "counter"


class Gauge(_Metric):
    kind = "gauge"


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, registry, buckets=DEFAULT_MS_BUCKETS):
        super().__init__(name, help, registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _new_state(self) -> dict:
        return {
            "counts": [0] * (len(self.buckets) + 1),  # +inf as last
            "sum": 0.0,
            "count": 0,
        }


class _Series:
    """One (metric, label set) time series. Cheap to re-derive — hold on to
    it on hot paths to skip the label lookup."""

    __slots__ = ("_metric", "_key", "_state")

    def __init__(self, metric: _Metric, key: tuple, state: dict):
        self._metric = metric
        self._key = key
        self._state = state

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0 and self._metric.kind == "counter":
            raise ValueError("counters only go up; use a gauge")
        with self._metric._lock():
            self._state["value"] += amount

    def set(self, value: float) -> None:
        if self._metric.kind != "gauge":
            raise TypeError(f"set() needs a gauge, not a {self._metric.kind}")
        with self._metric._lock():
            self._state["value"] = float(value)

    def observe(self, value: float) -> None:
        if self._metric.kind != "histogram":
            raise TypeError(
                f"observe() needs a histogram, not a {self._metric.kind}"
            )
        value = float(value)
        buckets = self._metric.buckets
        with self._metric._lock():
            st = self._state
            for i, bound in enumerate(buckets):
                if value <= bound:
                    st["counts"][i] += 1
                    break
            else:
                st["counts"][-1] += 1
            st["sum"] += value
            st["count"] += 1

    @property
    def value(self) -> float:
        with self._metric._lock():
            if self._metric.kind == "histogram":
                return float(self._state["sum"])
            return float(self._state["value"])

    @property
    def count(self) -> int:
        """Histogram observation count (0 for other kinds)."""
        with self._metric._lock():
            return int(self._state.get("count", 0))


class MetricsRegistry:
    """Named metric families, one namespace. ``counter``/``gauge``/
    ``histogram`` get-or-create (re-registering the same name returns the
    same family; a kind mismatch raises), ``render`` emits the Prometheus
    text format, and ``value(name, **labels)`` reads one series as a
    float — the primitive ``stats()`` dict views are built from."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.RLock()

    def _get_or_create(self, cls, name: str, help: str, **kwargs) -> _Metric:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name, help, self, **kwargs)
            elif not isinstance(metric, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {metric.kind}"
                )
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets=DEFAULT_MS_BUCKETS
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, **labels) -> float:
        """One series' value; 0.0 when the family or series never fired
        (absent counters read as zero, like Prometheus rate() treats them)."""
        metric = self.get(name)
        if metric is None:
            return 0.0
        key = tuple(sorted(labels.items()))
        with self._lock:
            state = metric._series.get(key)
            if state is None:
                return 0.0
        return _Series(metric, key, state).value

    def total(self, name: str) -> float:
        """One family's value summed across ALL of its label series (the
        Prometheus ``sum(name)`` aggregate; 0.0 for absent families) —
        what a labeled counter reads as when the caller doesn't care which
        label bucket the increments landed in."""
        metric = self.get(name)
        if metric is None:
            return 0.0
        return sum(
            state.get("sum", state.get("value", 0.0))
            for _, state in metric.collect()
        )

    def render(self) -> str:
        """The Prometheus text exposition of every registered family."""
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for metric in metrics:
            if metric.help:
                lines.append(f"# HELP {metric.name} {metric.help}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            for labels, state in metric.collect():
                if metric.kind == "histogram":
                    acc = 0
                    for bound, n in zip(metric.buckets, state["counts"]):
                        acc += n
                        le = {**labels, "le": f"{bound:g}"}
                        lines.append(
                            f"{metric.name}_bucket{_format_labels(le)} {acc}"
                        )
                    acc += state["counts"][-1]
                    le = {**labels, "le": "+Inf"}
                    lines.append(
                        f"{metric.name}_bucket{_format_labels(le)} {acc}"
                    )
                    lines.append(
                        f"{metric.name}_sum{_format_labels(labels)} "
                        f"{state['sum']:g}"
                    )
                    lines.append(
                        f"{metric.name}_count{_format_labels(labels)} "
                        f"{state['count']}"
                    )
                else:
                    lines.append(
                        f"{metric.name}{_format_labels(labels)} "
                        f"{state['value']:g}"
                    )
        return "\n".join(lines) + "\n"


class _ExpositionHandler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = None  # set per server class below

    def do_GET(self):  # noqa: N802 (http.server API)
        body = self.registry.render().encode()
        self.send_response(200)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet: scrapes are not stdout news
        pass


def start_exposition(
    registry: MetricsRegistry, port: int = 0, host: str = "127.0.0.1"
) -> ThreadingHTTPServer:
    """Serve ``registry.render()`` over HTTP on a daemon thread.

    ``port=0`` binds an ephemeral port — read the actual one off the
    returned server's ``server_address``. Call ``shutdown()`` +
    ``server_close()`` when done (the serving CLI does this on exit).
    """
    handler = type(
        "Handler", (_ExpositionHandler,), {"registry": registry}
    )
    server = ThreadingHTTPServer((host, port), handler)
    thread = threading.Thread(
        target=server.serve_forever, name="metrics-exposition", daemon=True
    )
    thread.start()
    return server
