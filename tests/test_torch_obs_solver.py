"""The port's solver phases and counters (``repro_torch.obs``): the span
tree of a ``prepare`` and a ``solve``, the profiler ranges that carry the
same phases onto the device trace's clock, the ``solver_*_total`` counters
against their exact values, and the served batch's phases and
``worker_idle_ms`` under a ``ManualClock``.

Small sizes, on the CPU: m = 200, n = 64, J = 8 wide blocks, k = 4.
"""
import asyncio
import urllib.request

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import consensus, prepare
from repro_torch.obs import clock as tclock
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serving import queue as tqueue

M, N, J, K, EPOCHS = 200, 64, 8, 4, 40
TOL = 1.0
KW = dict(num_blocks=J, mode="wide", materialize_p=False, use_kernels=True, device="cpu")
SOLVE_PHASES = ["solver.rhs", "solver.init", "solver.epochs", "solver.wait", "solver.fetch"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((M, N)).astype(np.float32)
    B = (A @ rng.standard_normal((N, K))).astype(np.float32)
    return A, B


@pytest.fixture(autouse=True)
def registry(monkeypatch):
    """A fresh process registry per test, so counts start at 0."""
    reg = tmetrics.MetricsRegistry()
    monkeypatch.setattr(tmetrics, "REGISTRY", reg)
    return reg


def _tree(records):
    by_id = {r["id"]: r for r in map(ttrace._linked, records)}
    return by_id, {i: by_id[r["parent"]]["name"] if r["parent"] else None
                   for i, r in by_id.items()}


def _inside(child, parent, slack_us=1e-3):
    return (parent["ts_us"] - slack_us <= child["ts_us"]
            and child["ts_us"] + child["dur_us"] <= parent["ts_us"] + parent["dur_us"] + slack_us)


@pytest.mark.parametrize("extra, prepare_phases", [
    ({}, ["solver.partition", "solver.qr", "solver.prepare_wait"]),
    ({"materialize_p": True, "dynamics": "per_block"},
     ["solver.partition", "solver.qr", "solver.projector", "solver.spectra",
      "solver.prepare_wait"]),
])
def test_prepare_and_solve_record_the_span_tree(system, extra, prepare_phases):
    A, B = system
    tracer = ttrace.Tracer()
    prep = prepare(A, **{**KW, **extra}, tracer=tracer)
    prep.solve(B, num_epochs=EPOCHS, tol=TOL)
    by_id, parent_name = _tree(tracer._records())
    names = [r["name"] for r in by_id.values()]
    assert sorted(names) == sorted(["solver.prepare", *prepare_phases,
                                    "solver.solve", *SOLVE_PHASES])
    for i, r in by_id.items():
        if r["name"] in ("solver.prepare", "solver.solve"):
            assert r["parent"] == 0
        else:
            want = "solver.prepare" if r["name"] in prepare_phases else "solver.solve"
            assert parent_name[i] == want
            assert _inside(r, by_id[r["parent"]])
    epochs = next(r for r in by_id.values() if r["name"] == "solver.epochs")
    assert {k: epochs["args"][k] for k in ("epochs", "k", "tol")} == {
        "epochs": EPOCHS, "k": K, "tol": TOL}
    assert all(r["cat"] == "solver" for r in by_id.values())
    # the children tile their parent in order: rhs, init, epochs, wait, fetch
    kids = sorted((r for r in by_id.values() if parent_name[r["id"]] == "solver.solve"),
                  key=lambda r: r["ts_us"])
    assert [r["name"] for r in kids] == SOLVE_PHASES
    selfs = ttrace.self_us(list(by_id.values()))
    solve = next(r for r in by_id.values() if r["name"] == "solver.solve")
    assert 0 <= selfs[solve["id"]] <= solve["dur_us"] - sum(r["dur_us"] for r in kids) + 1e-3


def _freeze_epochs(res, tol):
    """Per column, the first epoch whose residual is at or below tol² (the
    cap where none is), from the returned history alone."""
    h = np.asarray(res.history["residual_sq"])
    reached = h <= np.float32(tol * tol)
    return np.where(reached.any(axis=0), reached.argmax(axis=0) + 1, h.shape[0])


def _epochs_run(freeze, cap):
    """The epochs a tol solve runs on the CPU, where each poll is read at
    once: to the first poll (every ``POLL_EVERY`` epochs) after the last
    column froze, else the cap."""
    c = consensus.POLL_EVERY
    return min(cap, -(-int(freeze.max()) // c) * c)


@pytest.mark.parametrize("tol", [None, TOL])
def test_counters_equal_their_exact_values(system, registry, tol):
    A, B = system
    reg = registry
    prep = prepare(A, **KW)
    results = [prep.solve(B, num_epochs=EPOCHS, tol=tol) for _ in range(2)]
    p = prep.blocks.shape[1]
    v = reg.value
    assert v("solver_solves_total") == 2
    if tol is None:
        assert v("solver_epochs_total") == 2 * EPOCHS
        assert v("solver_column_epochs_total") == 2 * EPOCHS * K
        assert v("solver_active_column_epochs_total") == 2 * EPOCHS * K
        assert v("solver_early_stops_total") == 0
        assert v("solver_overrun_epochs_total") == 0
    else:
        r0 = np.asarray(results[0].history["initial"]["residual_sq"])
        assert (r0 > tol * tol).all()  # no column starts frozen
        freeze = [_freeze_epochs(r, tol) for r in results]
        assert all((f < EPOCHS).all() for f in freeze)  # every column froze
        # the epochs run, not the cap: each solve stops at its first poll
        # after the last freeze
        runs = [_epochs_run(f, EPOCHS) for f in freeze]
        assert all(ran < EPOCHS for ran in runs)
        assert v("solver_epochs_total") == sum(runs)
        assert v("solver_column_epochs_total") == sum(runs) * K
        assert v("solver_active_column_epochs_total") == sum(int(f.sum()) for f in freeze)
        assert v("solver_early_stops_total") == 2
        # the epochs each solve ran past its last column's freeze
        assert v("solver_overrun_epochs_total") == sum(
            ran - int(f.max()) for ran, f in zip(runs, freeze))
        assert v("solver_overrun_epochs_total") > 0
    # the CPU reads each poll in place: the host never waits on one
    assert v("solver_lead_waits_total") == 0
    # in: the blocked rhs, γ and η; out: x, the history and its initial row
    # (the full cap's rows); the polls block nothing, and on the CPU they
    # read the flag in place, copying nothing (the card test counts their
    # bytes against a profile)
    assert v("solver_host_syncs_total") == 2 * (3 + 1 + 3)
    assert v("solver_copy_bytes_total", direction="h2d") == 2 * (J * p * K * 4 + 4 + 4)
    assert v("solver_copy_bytes_total", direction="d2h") == 2 * (N * K + EPOCHS * K + K) * 4
    assert reg.total("solver_copy_bytes_total") == (
        v("solver_copy_bytes_total", direction="h2d")
        + v("solver_copy_bytes_total", direction="d2h"))


def test_a_column_that_never_freezes_runs_the_cap_with_no_overrun(system, registry):
    """A column off the range of A keeps its residual above tol²: the
    solve runs the cap, and no epoch counts as run past a freeze."""
    A, B = system
    B = B.copy()
    B[:, -1] = np.random.default_rng(6).standard_normal(M).astype(np.float32)
    prep = prepare(A, **KW)
    res = prep.solve(B, num_epochs=EPOCHS, tol=TOL)
    freeze = _freeze_epochs(res, TOL)
    assert (freeze[:-1] < EPOCHS).all() and freeze[-1] == EPOCHS
    v = registry.value
    assert v("solver_epochs_total") == EPOCHS and v("solver_early_stops_total") == 0
    assert v("solver_overrun_epochs_total") == 0 and v("solver_lead_waits_total") == 0


def test_the_lead_counters_carry_their_help(system, registry):
    """The two counters of the lead cap are registered with their help
    text, which keeps them apart from the blocking calls."""
    from repro_torch.core.prepared import SOLVER_COUNTERS

    A, B = system
    prepare(A, **KW).solve(B, num_epochs=EPOCHS, tol=TOL)
    text = registry.render()
    for name in ("solver_lead_waits_total", "solver_overrun_epochs_total"):
        assert f"# HELP {name} {SOLVER_COUNTERS[name]}" in text
    assert "solver_lead_waits_total" in SOLVER_COUNTERS["solver_host_syncs_total"]


def test_a_warm_started_solve_counts_its_operands(system, registry):
    """Each operand a solve copies in is one more blocking call."""
    A, B = system
    reg = registry
    prep = prepare(A, **KW)
    x0 = np.zeros((N, K), np.float32)
    prep.solve(B, num_epochs=5, x0=(x0, np.ones(K, bool)), x_ref=x0)
    p = prep.blocks.shape[1]
    # in: rhs, x_ref, x0 and its mask, γ, η; out: x and four history leaves
    # (residual_sq and mse, each with its initial row)
    assert reg.value("solver_host_syncs_total") == 6 + 1 + 5
    assert reg.value("solver_copy_bytes_total", direction="h2d") == (
        J * p * K * 4 + 2 * N * K * 4 + K + 8)


def test_counters_default_to_the_process_registry(system):
    A, B = system
    before = tmetrics.REGISTRY.value("solver_solves_total")
    prepare(A, **KW).solve(B[:, 0], num_epochs=3)
    assert tmetrics.REGISTRY.value("solver_solves_total") == before + 1
    assert tmetrics.REGISTRY.value("solver_column_epochs_total") >= 3


@pytest.fixture
def count_ranges(monkeypatch):
    opened = []
    real = ttrace._host_range

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(ttrace, "_host_range", counting)
    return opened


def test_tracing_off_records_nothing_and_changes_no_bit(system, count_ranges):
    A, B = system
    assert not torch.autograd._profiler_enabled()
    tracer = ttrace.Tracer()
    runs = {}
    for label, tr in (("off", None), ("on", tracer)):
        prep = prepare(A, **KW, tracer=tr)
        runs[label] = prep.solve(B, num_epochs=EPOCHS, tol=TOL)
    assert count_ranges == []  # no profiler: no range, traced or not
    assert len(tracer.spans()) == 4 + 6  # the prepare's and the solve's
    with profile(activities=[ProfilerActivity.CPU]):
        prep = prepare(A, **KW)
        runs["profiled"] = prep.solve(B, num_epochs=EPOCHS, tol=TOL)
    assert sorted(count_ranges) == sorted(
        ["solver.prepare", "solver.partition", "solver.qr", "solver.prepare_wait",
         "solver.solve", *SOLVE_PHASES])
    for label in ("on", "profiled"):
        np.testing.assert_array_equal(runs[label].x, runs["off"].x)
        for key in ("residual_sq",):
            np.testing.assert_array_equal(runs[label].history[key], runs["off"].history[key])
        np.testing.assert_array_equal(runs[label].history["initial"]["residual_sq"],
                                      runs["off"].history["initial"]["residual_sq"])


def test_untraced_entry_points_make_one_check(system, monkeypatch):
    """Untraced, an entry point asks the profiler once and opens no phase."""
    A, B = system
    prep = prepare(A, **KW)
    checks = []
    real = ttrace.profiling
    monkeypatch.setattr(ttrace, "profiling", lambda: checks.append(1) or real())
    monkeypatch.setattr(ttrace, "_Phase", None)  # any phase would raise
    prep.solve(B, num_epochs=EPOCHS, tol=TOL)
    assert len(checks) == 1


def test_profiler_ranges_share_the_tracers_tree(system):
    """On the CPU profiler's clock: every solver span is a host range, as
    many of each name as the tracer recorded, each inside its parent's."""
    A, B = system
    tracer = ttrace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prep = prepare(A, **KW, tracer=tracer)
        for _ in range(2):
            prep.solve(B, num_epochs=EPOCHS, tol=TOL)
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("solver.")]
    assert all(e.device_type() == DeviceType.CPU for e in events)
    spans = tracer._records()
    ranges = {}
    for e in events:
        ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    assert {n: len(v) for n, v in ranges.items()} == {
        n: sum(r["name"] == n for r in spans) for n in {r["name"] for r in spans}}
    _, parent_name = _tree(spans)
    for r in map(ttrace._linked, spans):
        parent = parent_name[r["id"]]
        if parent is None:
            continue
        for s, e in ranges[r["name"]]:
            assert any(ps <= s and e <= pe for ps, pe in ranges[parent]), r["name"]


def test_a_profile_of_all_threads_records_a_worker_threads_phases(system):
    """A profile started on one thread with ``profile_all_threads`` (as the
    benchmark's traced run starts it) leaves the thread-local profiler
    state off elsewhere; a solve on another thread still records."""
    import threading

    from torch._C._profiler import _ExperimentalConfig

    A, B = system
    prep = prepare(A, **KW)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        worker = threading.Thread(target=prep.solve, args=(B,), kwargs={"num_epochs": 5})
        worker.start()
        worker.join()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("solver.")]
    assert sorted(names) == sorted(["solver.solve", *SOLVE_PHASES])


def test_span_links_export_and_load(tmp_path):
    clk = tclock.ManualClock()
    tracer = ttrace.Tracer(clock=clk)
    phase = ttrace.recorder(tracer)
    with phase("solver.solve") as outer:
        clk.advance(1.0)
        with phase("solver.epochs", epochs=3) as inner:
            clk.advance(2.0)
        clk.advance(1.0)
    batch = tracer.new_span_id()
    with tracer.within(batch):
        with phase("solver.fetch"):
            clk.advance(0.5)
    tracer.span_at("batch", 0.0, 5.0, span_id=batch)
    for fmt in ("chrome", "jsonl"):
        path = tmp_path / f"t.{fmt}"
        getattr(tracer, f"export_{fmt}")(path)
        recs = {r["name"]: r for r in ttrace.load_trace(path)}
        assert (recs["solver.epochs"]["id"], recs["solver.epochs"]["parent"]) == (inner, outer)
        assert recs["solver.solve"]["parent"] == 0
        assert recs["solver.fetch"]["parent"] == recs["batch"]["id"] == batch
        assert recs["solver.epochs"]["args"]["epochs"] == 3
        selfs = ttrace.self_us(list(recs.values()))
        assert selfs[outer] == pytest.approx(2e6)
        assert selfs[batch] == pytest.approx(4.5e6)
    assert tracer.current() == 0


def test_exposition_renders_the_process_registry_beside_the_servers():
    own = tmetrics.MetricsRegistry()
    own.counter("server_requests_total", "requests").inc(3)
    proc = tmetrics.MetricsRegistry()
    proc.counter("solver_solves_total", "solves").inc(2)
    server = tmetrics.start_exposition(own, port=0, also=(proc,))
    try:
        host, port = server.server_address[:2]
        body = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10).read().decode()
    finally:
        server.shutdown()
        server.server_close()
    assert body == own.render() + proc.render()


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


def test_served_batches_parent_their_phases(system):
    A, B = system
    tracer = ttrace.Tracer()

    async def main():
        async with tqueue.SolveServer(max_batch=2, max_wait_ms=2.0, num_epochs=10,
                                      prepare_kwargs=dict(KW), tracer=tracer) as server:
            fp = server.register(A)
            await asyncio.gather(*(server.submit(fp, B[:, i]) for i in range(4)))

    _run(main())
    by_id, parent_name = _tree(tracer._records())
    batches = {i for i, r in by_id.items() if r["name"] == "batch"}
    assert len(batches) >= 2
    for name in ("batch.assemble", "batch.deliver", "solver.solve"):
        spans = [r for r in by_id.values() if r["name"] == name]
        assert len(spans) == len(batches), name
        assert {r["parent"] for r in spans} == batches, name
    prepares = [r for r in by_id.values() if r["name"] == "solver.prepare"]
    assert len(prepares) == 1 and prepares[0]["parent"] in batches  # the first batch's miss


def test_worker_idle_ms_under_a_manual_clock(system):
    """A scripted arrival sequence, two requests a batch: the worker sits
    free from its last run's end (or the oldest request's enqueue, if
    later) to the next run's start."""
    A, B = system
    clk = tclock.ManualClock(100.0)

    async def main():
        async with tqueue.SolveServer(max_batch=2, max_wait_ms=60_000.0, num_epochs=5,
                                      prepare_kwargs=dict(KW), clock=clk) as server:
            fp = server.register(A)

            async def pair(first_at, second_at):
                clk.current = 100.0 + first_at
                one = asyncio.ensure_future(server.submit(fp, B[:, 0]))
                for _ in range(5):
                    await asyncio.sleep(0)
                clk.current = 100.0 + second_at
                two = asyncio.ensure_future(server.submit(fp, B[:, 1]))
                return await asyncio.gather(one, two)

            out = []
            for first_at, second_at in ((0.0, 0.0), (1.0, 3.0), (3.5, 3.5), (4.0, 4.25)):
                out.append(await pair(first_at, second_at))
            return out, server.metrics

    out, reg = _run(main())
    idle = [[r.worker_idle_ms for r in results] for results in out]
    # first batch 0; 3 − max(0, 1); 3.5 − max(3, 3.5); 4.25 − max(3.5, 4)
    assert idle == [[0.0, 0.0], [2000.0, 2000.0], [0.0, 0.0], [250.0, 250.0]]
    assert reg.get("server_worker_idle_ms").labels().count == 4
    assert reg.value("server_worker_idle_ms") == 2250.0


class _TickingClock(tclock.Clock):
    """Moves 1 µs on every read, from any thread: no two readings are
    equal, so a child that starts before its parent or ends after it shows."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self.t = 100.0

    def now(self) -> float:
        with self._lock:
            self.t += 1e-6
            return self.t


@pytest.mark.parametrize("poisoned", [False, True], ids=["clean", "poisoned"])
def test_served_phases_nest_inside_their_parents_on_a_moving_clock(system, poisoned):
    """Every linked span on the server track lies inside its parent, on
    the server's own clock: the batch span runs from the take to the end
    of the delivery. Poisoned, the failed batch, its bisected halves and
    the recovery ladder's attempts nest the same way."""
    from repro_torch.serving import faults as tfaults

    A, B = system
    clk = _TickingClock()
    tracer = ttrace.Tracer(clock=clk)

    async def main():
        async with tqueue.SolveServer(max_batch=3, max_wait_ms=2.0, num_epochs=10,
                                      prepare_kwargs=dict(KW), tracer=tracer,
                                      clock=clk) as server:
            fp = server.register(A)
            if poisoned:
                rule = dict(site="solve", kind="error", request=server.next_request_seq + 1)
                server.faults = server.pool.faults = tfaults.FaultInjector(
                    tfaults.FaultPlan(rules=(rule,), seed=0))
            return await asyncio.gather(*(server.submit(fp, B[:, i % K]) for i in range(6)),
                                        return_exceptions=True)

    results = _run(main())
    assert sum(isinstance(r, Exception) for r in results) == int(poisoned)
    by_id = {r["id"]: r for r in map(ttrace._linked, tracer._records())}
    names = [r["name"] for r in by_id.values()]
    assert names.count("batch") >= 2 and "batch.assemble" in names
    if poisoned:
        assert any(r["args"].get("reason") == "bisect" for r in by_id.values())
        assert any(r["name"].startswith("recover.") for r in by_id.values())
    linked = [r for r in by_id.values()
              if r["trace_id"] == ttrace.SERVER_TRACK and r["parent"]]
    assert {r["name"] for r in linked} >= {"batch.assemble", "batch.deliver", "solver.solve"}
    for r in linked:
        parent = by_id[r["parent"]]
        assert parent["ts_us"] < r["ts_us"], (r["name"], parent["name"])
        assert r["ts_us"] + r["dur_us"] < parent["ts_us"] + parent["dur_us"], (
            r["name"], parent["name"])
