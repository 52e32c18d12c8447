"""Shared arithmetic of the metric readers (``perfbench/e2e/*.py`` and
``perfbench/metrics/*.py``). A reader returns None where its cell gives it
nothing to read; a share of a roofline or a peak is never made up as 0.
The shares below count the operations and bytes of the dense solver
(``harness/counts.py``), so on a matrix-free context they read None."""
from __future__ import annotations

import numpy as np

from perfbench.harness import counts


def is_served(ctx) -> bool:
    return ctx.window.latencies_ms is not None


def served_results(ctx) -> list:
    """The served requests' ``RequestResult``s, of the requests due before
    the traced stretch in a traced run."""
    w = ctx.window
    return [res for i, res in enumerate(w.results)
            if res is not None and not isinstance(res, BaseException)
            and (w.clean is None or w.clean[i])]


def served_batches(ctx) -> list[tuple[int, float, int]]:
    """(requests, solve_ms, epochs needed) of each clean served batch; the
    requests of one batch share its solve_ms and batch_size."""
    batches: dict = {}
    for res in served_results(ctx):
        key = (res.solve_ms, res.batch_size)
        batches[key] = max(batches.get(key, 0), int(res.iterations))
    return [(size, ms, need) for (ms, size), need in batches.items()]


def kernel_roofline(ctx, kernels: tuple[str, ...], least_s: float) -> float | None:
    """100 × the least time of one call over the mean device time of one
    call of the kernels (a call is one execution of the last one named)."""
    tr = ctx.trace
    if tr is None:
        return None
    calls = tr.count(kernels[-1])
    device_s = sum(tr.device_seconds(k) for k in kernels)
    if calls == 0 or device_s <= 0:
        return None
    return 100.0 * least_s / (device_s / calls)


def consensus_update_roofline(ctx) -> float | None:
    if ctx.path != "dense":
        return None
    least = counts.least_seconds(*counts.consensus_update_call(ctx.J, ctx.p, ctx.n, ctx.k))
    return kernel_roofline(ctx, ("wv_kernel", "update_kernel"), least)


def trisolve_roofline(ctx) -> float | None:
    if ctx.path != "dense":
        return None
    least = counts.least_seconds(*counts.trisolve_call(ctx.J, ctx.p, ctx.k))
    return kernel_roofline(ctx, ("trisolve_kernel",), least)


def solve_mfu(ctx) -> float | None:
    """100 × the solves' least time over their measured time, over the
    solves before the traced stretch (closed loop) or the clean served
    batches (their server-side solve_ms)."""
    if ctx.path != "dense":
        return None
    if is_served(ctx):
        batches = served_batches(ctx)
        if not batches:
            return None
        least = sum(counts.solve_least_seconds(ctx.J, ctx.p, ctx.n, size, need)
                    for size, _, need in batches)
        return 100.0 * least / (sum(ms for _, ms, _ in batches) / 1e3)
    w = ctx.window
    if w.clean_solves == 0 or w.clean_seconds <= 0:
        return None
    least = sum(counts.solve_least_seconds(ctx.J, ctx.p, ctx.n, ctx.k, need)
                for need in w.needed_epochs[:w.clean_solves])
    return 100.0 * least / w.clean_seconds


def idle_share(ctx) -> float | None:
    tr = ctx.trace
    if tr is None or tr.window_ns <= 0 or tr.busy_ns <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns / tr.window_ns)


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    v = np.sort(np.asarray(values, np.float64))
    return float(v[max(0, int(np.ceil(0.95 * v.size)) - 1)])
