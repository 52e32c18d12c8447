"""Device-trace reading for the traced run.

``TraceWindow`` runs ``torch.profiler`` over a stretch of the window (CPU
and CUDA activity; every host thread where the installed PyTorch can record
them) and, when it stops, reduces the raw events to aggregates and drops
them: per device operation its count and device time, the union of the
device's busy intervals, and the device's idle gaps named by what the host
was doing under them (the innermost ``bench.*`` span of the harness and the
innermost host operation covering the gap's middle).
"""
from __future__ import annotations

import dataclasses
import heapq
import re
import time
from collections import defaultdict

BENCH_SPAN = "bench."  # prefix of the harness's own host spans
_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass
class TraceStats:
    """What a traced stretch leaves behind."""

    ops: dict = dataclasses.field(default_factory=lambda: defaultdict(lambda: [0, 0]))
    kernels: int = 0  # kernel executions (copies and fills of memory excluded)
    busy_ns: int = 0  # union of every device operation's interval
    window_ns: int = 0  # the traced stretch, host clock
    gaps: dict = dataclasses.field(default_factory=lambda: defaultdict(int))  # label -> ns

    def _named(self, kernel: str):
        pat = re.compile(rf"(^|[\s:]){re.escape(kernel)}[<(]|^{re.escape(kernel)}$")
        return [agg for name, agg in self.ops.items() if pat.search(name)]

    def count(self, kernel: str) -> int:
        """Executions of the device function ``kernel`` (any instantiation)."""
        return sum(c for c, _ in self._named(kernel))

    def device_seconds(self, kernel: str) -> float:
        return sum(t for _, t in self._named(kernel)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {
            "device_ops": [[name[:160], t / 1e9] for name, (_, t) in ops],
            "idle_gaps": [[label[:160], t / 1e9] for label, t in gaps],
        }


def _activity(e) -> str:
    fn = getattr(e, "activity_type", None)
    return fn() if callable(fn) else ""


def _merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _label_gaps(gaps, host):
    """For each gap (start, end), the label of the host activity covering its
    middle: a sweep over host events sorted by start, keeping the active ones
    in two heaps keyed by duration (innermost first)."""
    mids = sorted(((s + e) // 2, i) for i, (s, e) in enumerate(gaps))
    host = sorted(host)
    labels = [""] * len(gaps)
    spans: list = []
    ops: list = []
    j = 0
    for mid, i in mids:
        while j < len(host) and host[j][0] <= mid:
            s, e, name = host[j]
            heapq.heappush(spans if name.startswith(BENCH_SPAN) else ops, (e - s, e, name))
            j += 1
        for heap in (spans, ops):
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
        span = spans[0][2] if spans else "outside bench spans"
        op = ops[0][2] if ops else "python"
        labels[i] = f"{span} / {op}"
    return labels


class TraceWindow:
    """Start and stop ``torch.profiler`` around stretches of a window; the
    aggregates of every stretch add up in ``stats``."""

    def __init__(self, torch):
        self.torch = torch
        self.stats = TraceStats()
        self._prof = None
        self._t0 = 0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        kwargs = {}
        try:
            from torch._C._profiler import _ExperimentalConfig

            kwargs["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass  # an older PyTorch records the host ops of the starting thread only
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kwargs)
        self._prof.__enter__()
        self._t0 = time.perf_counter_ns()

    def stop(self, keep: bool = True) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        if keep:
            self._reduce(prof.profiler.kineto_results.events(), t1 - self._t0)
        del prof

    def warm(self, device) -> None:
        """Trace one small device operation and drop it: the profiler's first
        start sets up CUPTI, which takes seconds, and that belongs to set-up."""
        self.start()
        (self.torch.ones(1024, device=device) * 2).sum().item()
        self.stop(keep=False)

    def _reduce(self, events, window_ns: int) -> None:
        from torch.autograd import DeviceType

        st = self.stats
        st.window_ns += window_ns
        device, host = [], []
        lo, hi = None, None
        for e in events:
            s = e.start_ns()
            end = s + e.duration_ns()
            lo = s if lo is None or s < lo else lo
            hi = end if hi is None or end > hi else hi
            kind = _activity(e)
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if "annotation" in kind or name.startswith(BENCH_SPAN):
                    continue
                agg = st.ops[name]
                agg[0] += 1
                agg[1] += end - s
                if not name.startswith(_COPY_PREFIXES) and "memcpy" not in kind \
                        and "memset" not in kind:
                    st.kernels += 1
                device.append((s, end))
            else:
                host.append((s, end, name))
        if lo is None:
            return
        busy = _merge(device)
        st.busy_ns += sum(e - s for s, e in busy)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        for (s, e), label in zip(gaps, _label_gaps(gaps, host)):
            st.gaps[label] += e - s
