"""The two ways a window drives the program.

``closed_loop``: one client calls ``PreparedSolver.solve`` on a batch of k
right-hand sides and sends the next batch when the last returned its numpy
result, cycling a pool of batches made at set-up; the window is all the
time of the calls started in it.

``open_loop``: independent clients send single right-hand sides to a
``SolveServer`` on a schedule drawn from the seed; each request is timed
from the moment it was due to its result, whether the generator was late or
the server was; every request due in the window is awaited, up to a minute
past its close.

With a ``TraceWindow`` each traces a steady stretch late in its window and
keeps the timings of the stretch before it clean for the metrics that read
time per solve.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time

import numpy as np
import torch

from perfbench.harness.compare import Answer

LATE_GRACE_S = 60.0  # how long past the window's close a due request is awaited
TRACE_FROM = 0.5  # the traced stretch starts at this share of the window
TRACE_SOLVES = (3, 40)  # closed loop: fewest and most solves traced


@dataclasses.dataclass
class Window:
    """What one window measured, on the host's clock."""

    seconds: float  # the window's length
    attempted: int
    failed: int
    answers: list  # compare.Answer of every completed solve or request
    peak_bytes: int
    solves: int = 0  # closed loop: solves completed in the window
    clean_solves: int = 0  # solves before the traced stretch ...
    clean_seconds: float = 0.0  # ... and their time
    traced_solves: int = 0
    needed_epochs: list = dataclasses.field(default_factory=list)  # per solve
    latencies_ms: np.ndarray | None = None  # open loop: every request due
    results: list = dataclasses.field(default_factory=list)  # open loop: RequestResult
    clean: np.ndarray | None = None  # open loop: requests due before the traced stretch
    lateness_ms: np.ndarray | None = None  # open loop: generator's lateness per request


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _open_window(device, mark) -> None:
    """The window starts: the device is idle, its peak is reset, and
    ``mark`` (the set-up clock) is called."""
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    mark()


def _peak(device) -> int:
    _sync(device)
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _history(res) -> np.ndarray:
    h = np.asarray(res.history["residual_sq"], np.float64)
    h = h[:, None] if h.ndim == 1 else h
    h0 = np.atleast_1d(np.asarray(res.history["initial"]["residual_sq"], np.float64))
    return np.concatenate([h0[None, :], h], axis=0)


def _iterations(hist: np.ndarray, epochs: int, tol) -> np.ndarray:
    if tol is None:
        return np.full(hist.shape[1], epochs, np.int64)
    reached = hist[1:] <= float(tol) ** 2
    return np.where(reached.any(axis=0), reached.argmax(axis=0) + 1, epochs).astype(np.int64)


def closed_loop(prep, pool, options, seconds: float, mark, tracer=None,
                warmup: int = 2) -> Window:
    """Batched solves back to back for ``seconds``; ``pool`` is a list of host
    (m, k) arrays, ``options`` the ``SolveOptions`` of every call; ``mark``
    is called when the window opens, after the warm-up."""
    from torch.profiler import record_function

    epochs, tol = int(options.num_epochs), options.tol
    for i in range(warmup):
        prep.solve(pool[i % len(pool)], options)
    _open_window(prep.device, mark)
    answers, needed = [], []
    failed = 0
    trace_at, trace_first, trace_n = None, None, 0
    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - t0
        traced = 0 if trace_first is None else i - trace_first
        if tracer is not None and not tracer.active and trace_first is None \
                and now >= TRACE_FROM * seconds:
            trace_at, trace_first = now, i
            tracer.start()
        if now >= seconds and (tracer is None or traced >= TRACE_SOLVES[0]):
            break
        b = pool[i % len(pool)]
        try:
            with record_function("bench.solve"):
                res = prep.solve(b, options)
        except Exception as exc:  # a failed call counts; the loop goes on
            failed += 1
            print(f"perfbench: solve {i} failed: {exc!r}", flush=True)
            i += 1
            continue
        i += 1
        hist = _history(res)
        it = _iterations(hist, epochs, tol)
        needed.append(int(it.max()))
        answers.append(Answer(b=b, x=np.asarray(res.x), iterations=it, history=hist))
        if tracer is not None and tracer.active and (
                i - trace_first >= TRACE_SOLVES[1]
                or (time.perf_counter() - t0 >= seconds and i - trace_first >= TRACE_SOLVES[0])):
            trace_n = i - trace_first
            tracer.stop()
    window_s = time.perf_counter() - t0
    if tracer is not None and tracer.active:
        trace_n = i - trace_first
        tracer.stop()
    peak = _peak(prep.device)
    clean_n = i if trace_first is None else trace_first
    return Window(
        seconds=window_s, attempted=i, failed=failed, answers=answers, peak_bytes=peak,
        solves=i - failed, clean_solves=clean_n,
        clean_seconds=window_s if trace_at is None else trace_at,
        traced_solves=trace_n,
        needed_epochs=needed,
    )


def open_loop(server, fingerprint, device, rhs: np.ndarray, due_s: np.ndarray,
              seconds: float, warm: np.ndarray, mark, tracer=None) -> Window:
    """Request i (column i of ``rhs``) is due ``due_s[i]`` seconds into the
    window; ``warm`` (m, w) is sent before the window in batches the size of
    the server's ``max_batch``; ``mark`` is called when the window opens."""
    return asyncio.run(_open_loop(server, fingerprint, device, rhs, due_s, seconds, warm,
                                  mark, tracer))


def span_solves(prep) -> None:
    """A host span around each solve of ``prep``, from the harness's side:
    the solver object the server's worker thread calls gets a wrapper on the
    instance."""
    from torch.profiler import record_function

    inner = prep.solve

    def solve(*args, **kwargs):
        with record_function("bench.batch_solve"):
            return inner(*args, **kwargs)

    prep.solve = solve


async def _open_loop(server, fp, device, rhs, due_s, seconds, warm, mark, tracer):
    cap = server.max_batch
    for lo in range(0, warm.shape[1], cap):
        await asyncio.gather(*(server.submit(fp, warm[:, c])
                               for c in range(lo, min(lo + cap, warm.shape[1]))))
    _open_window(device, mark)
    n = rhs.shape[1]
    lat = np.full(n, np.nan)
    late = np.zeros(n)
    results: list = [None] * n

    async def one(i: int, due_abs: float):
        try:
            res = await server.submit(fp, rhs[:, i])
        except Exception as exc:  # a failed request counts as missing
            results[i] = exc
            return
        lat[i] = (time.perf_counter() - due_abs) * 1e3
        results[i] = res

    trace_from = TRACE_FROM * seconds
    tasks = []
    t0 = time.perf_counter()
    for i in range(n):
        due_abs = t0 + float(due_s[i])
        delay = due_abs - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        if tracer is not None and not tracer.active and due_s[i] >= trace_from:
            tracer.start()
        late[i] = (time.perf_counter() - due_abs) * 1e3
        tasks.append(asyncio.create_task(one(i, due_abs)))
    remaining = max(0.0, t0 + seconds - time.perf_counter())
    if tasks:
        await asyncio.wait(tasks, timeout=remaining + LATE_GRACE_S)
    if tracer is not None and tracer.active:
        tracer.stop()
    peak = _peak(device)
    for t in tasks:
        if not t.done():
            t.cancel()
    await server.aclose()
    failed = 0
    answers = []
    for i, res in enumerate(results):
        if res is None or isinstance(res, BaseException):
            failed += 1
            lat[i] = (time.perf_counter() - (t0 + float(due_s[i]))) * 1e3
            continue
        answers.append(Answer(
            b=rhs[:, i:i + 1], x=np.asarray(res.x)[:, None],
            iterations=np.array([res.iterations], np.int64), history=None,
            final=np.array([res.residual_sq], np.float64)))
    return Window(
        seconds=seconds, attempted=n, failed=failed, answers=answers, peak_bytes=peak,
        latencies_ms=lat, results=results, clean=due_s < trace_from if tracer else None,
        lateness_ms=late,
    )
