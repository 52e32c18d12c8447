"""The port's observability layer for serving against the JAX package's
(``tests/test_obs.py``, case by case): the clock, the metrics registry and
its Prometheus text, the tracer and its two export formats, the serving
stats view, and a traced serving run.

Parity is exact where both packages compute the same host-side thing: fed
the same sequence of metric updates, the two registries render the same
text byte for byte; a ``ManualClock`` replay through either package's
``SolveServer`` reports the same latencies, spans and metrics text; and the
JAX package's ``load_trace`` and the unchanged ``tools/trace_report.py``
read the port's exports. The per-block convergence cases of
``tests/test_obs.py`` are held in ``tests/test_torch_guard.py``; the
sharded ones are stubs of ROADMAP Queue 1 item 8 here.

Small sizes: n = 96, m = 384, J = 8, as the reference's tests.
"""
import asyncio
import json
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given
from hypothesis import strategies as st

from repro.obs import clock as jclock
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.serving import queue as jqueue
from repro_torch import obs as tobs
from repro_torch.core import prepare as tprepare
from repro_torch.obs import clock as tclock
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serving import queue as tqueue
from repro_torch.sparse import make_problem

ROOT = Path(__file__).resolve().parent.parent
JAX_KW = dict(num_blocks=8, materialize_p=False)
PORT_KW = dict(JAX_KW, device="cpu")

STATS_SCHEMA = {
    "requests", "batches", "full_batches", "timeout_flushes",
    "deadline_flushes", "drain_flushes", "interactive_batches",
    "bulk_batches", "admission_rejects", "mean_batch_size",
    "prepares", "hits", "evictions", "restores", "restore_ms",
    "gets", "misses", "failures", "retries", "recovered_requests",
    "failed_requests", "cancelled", "block_imbalance",
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small solves of many tiny ops: one intra-op thread keeps them fast
    when parallel test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def problem():
    return make_problem(n=96, m=384, seed=3, dtype=np.float32)


@pytest.fixture(scope="module")
def rhs_batch(problem):
    rng = np.random.default_rng(17)
    xs = rng.standard_normal((96, 4)).astype(np.float32)
    return problem.A @ xs, xs


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


# -- clock --------------------------------------------------------------------


def test_manual_clock_advances_as_the_reference():
    jc, tc = jclock.ManualClock(), tclock.ManualClock()
    for step in (0.0, 1.5, 0.25, 3.0):
        assert jc.advance(step) == tc.advance(step)
        assert jc.now() == tc.now()
    for clk in (jc, tc):
        with pytest.raises(ValueError):
            clk.advance(-1.0)


def test_real_clock_is_monotonic():
    clk = tclock.Clock()
    a, b = clk.now(), clk.now()
    assert b >= a
    assert tclock.now() <= tclock.DEFAULT.now()


# -- metrics ------------------------------------------------------------------

_OPS = st.lists(
    st.tuples(
        st.sampled_from(["counter", "gauge", "histogram"]),
        st.sampled_from(["a_total", "b_ms", "c"]),
        st.sampled_from([None, "x", "y"]),
        st.floats(min_value=0.0, max_value=1e4, allow_nan=False),
        st.booleans(),
    ),
    max_size=25,
)


def _apply(module, ops):
    """One sequence of metric updates on a fresh registry of ``module``;
    kind clashes raise in both packages and are skipped alike."""
    reg = module.MetricsRegistry()
    for kind, name, label, value, reset in ops:
        name = f"{kind}_{name}"
        try:
            metric = getattr(reg, kind)(name, f"help of {name}")
        except ValueError:
            continue
        series = metric if label is None else metric.labels(kind=label)
        if kind == "counter":
            series.inc(value)
        elif kind == "gauge":
            series.set(value)
        else:
            series.observe(value)
        if reset:
            metric.reset()
    return reg


@given(_OPS)
def test_render_equals_the_reference_byte_for_byte(ops):
    j, t = _apply(jmetrics, ops), _apply(tmetrics, ops)
    assert t.render() == j.render()
    for kind, name, label, _, _ in ops:
        full = f"{kind}_{name}"
        labels = {} if label is None else {"kind": label}
        assert t.value(full, **labels) == j.value(full, **labels)
        assert t.total(full) == j.total(full)


def test_counter_labels_and_values():
    reg = tmetrics.MetricsRegistry()
    c = reg.counter("reqs_total", "requests")
    c.labels(kind="a").inc()
    c.labels(kind="a").inc(2)
    c.labels(kind="b").inc()
    assert reg.value("reqs_total", kind="a") == 3.0
    assert reg.value("reqs_total", kind="b") == 1.0
    assert reg.value("reqs_total", kind="missing") == 0.0
    assert reg.value("never_registered") == 0.0
    with pytest.raises(ValueError):
        c.inc(-1)
    reg.counter("x_total")
    with pytest.raises(ValueError):
        reg.gauge("x_total")


def test_histogram_buckets_and_gauge_reset():
    reg = tmetrics.MetricsRegistry()
    h = reg.histogram("lat_ms", "latency", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    text = reg.render()
    for line in ('lat_ms_bucket{le="1"} 1', 'lat_ms_bucket{le="10"} 2',
                 'lat_ms_bucket{le="+Inf"} 3', "lat_ms_count 3", "lat_ms_sum 55.5",
                 "# TYPE lat_ms histogram"):
        assert line in text
    g = reg.gauge("ewma_s")
    g.set(0.25)
    assert reg.value("ewma_s") == 0.25
    reg.get("ewma_s").reset()
    assert reg.value("ewma_s") == 0.0


def test_exposition_endpoint_serves_the_reference_text():
    regs = []
    for module in (jmetrics, tmetrics):
        reg = module.MetricsRegistry()
        reg.counter("up_total", "liveness").inc()
        reg.histogram("lat_ms", "latency").observe(3.0)
        regs.append(reg)
    server = tmetrics.start_exposition(regs[1], port=0)
    try:
        host, port = server.server_address[:2]
        body = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10).read().decode()
    finally:
        server.shutdown()
        server.server_close()
    assert body == regs[0].render()
    assert "up_total 1" in body and "# TYPE up_total counter" in body


# -- tracer -------------------------------------------------------------------


def _traced(module, clock_module):
    clk = clock_module.ManualClock()
    tracer = module.Tracer(clock=clk)
    tid = tracer.new_trace_id()
    span = tracer.begin("queue", trace_id=tid, cat="request", priority="bulk")
    clk.advance(0.010)
    span.end(batch=3)
    tracer.span_at("batch", 0.0, 0.010, cat="server", size=3)
    with tracer.span("work", cat="test"):
        clk.advance(0.002)
    return tracer, tid, span


def _unlinked(doc):
    """An export with the port's span links (``id``, ``parent`` in each
    span's args) taken out: what the reference writes."""
    if isinstance(doc, dict):
        return {k: _unlinked(v) for k, v in doc.items()
                if k not in ("id", "parent") or not isinstance(v, int)}
    if isinstance(doc, list):
        return [_unlinked(v) for v in doc]
    return doc


def _read_export(path, fmt):
    text = path.read_text()
    return json.loads(text) if fmt == "chrome" else [json.loads(x) for x in text.splitlines()]


def test_spans_round_trip_both_formats_across_packages(tmp_path):
    tracer, tid, span = _traced(ttrace, tclock)
    ref, _, _ = _traced(jtrace, jclock)
    assert span.duration_ms == pytest.approx(10.0)
    for fmt in ("chrome", "jsonl"):
        ours, theirs = tmp_path / f"t.{fmt}", tmp_path / f"r.{fmt}"
        assert getattr(tracer, f"export_{fmt}")(ours) == 3
        getattr(ref, f"export_{fmt}")(theirs)
        assert _unlinked(_read_export(ours, fmt)) == _read_export(theirs, fmt)
        for load in (jtrace.load_trace, ttrace.load_trace):
            recs = load(ours)
            by_name = {r["name"]: r for r in recs}
            assert by_name["queue"]["trace_id"] == tid
            assert by_name["queue"]["dur_us"] == pytest.approx(10_000.0)
            assert _unlinked(by_name["queue"]["args"]) == {"priority": "bulk", "batch": 3}
            assert by_name["batch"]["trace_id"] == ttrace.SERVER_TRACK
        links = {r["name"]: (r["id"], r["parent"]) for r in ttrace.load_trace(ours)}
        assert links == {"queue": (1, 0), "batch": (2, 0), "work": (3, 0)}
    events = json.loads((tmp_path / "t.chrome").read_text())["traceEvents"]
    names = {e["args"]["name"] for e in events if e.get("ph") == "M"}
    assert "server" in names and f"request {tid}" in names
    tracer.clear()
    assert tracer.spans() == []


# -- the collective audit and sharded serving (the multi-device slice) ---------


@pytest.mark.parametrize("name", ["audit_epoch_collectives", "collect_reduces"])
def test_collective_audit_is_an_item_8_stub(problem, name):
    """The audit, once a stub: a sharded solve's epochs pay one n·k
    all-reduce, counted from the calls it makes."""
    from test_torch_matfree_sharded import one_rank_mesh

    n = problem.A.shape[1]
    with one_rank_mesh() as mesh:
        prep = tprepare(problem.A, mode="matfree", mesh=mesh, **PORT_KW)
        if name == "audit_epoch_collectives":
            audit = tobs.audit_epoch_collectives(prep, problem.b, num_epochs=3)
            assert (audit["ops"], audit["payload_elems"]) == (1, n)
        else:
            with prep.comm.recording() as rec:
                prep.solve(problem.b, num_epochs=3)
            calls = tobs.collect_reduces(rec)
            assert [c for c in calls if c[0]] == [(True, "all_reduce_sum", n)] * 3


def test_sharded_serving_is_an_item_8_stub(problem):
    """A mesh registration, once refused: the pool holds the sharded solver
    and the server answers as a direct sharded solve."""
    from test_torch_matfree_sharded import one_rank_mesh

    with one_rank_mesh() as mesh:
        kw = dict(PORT_KW, mesh=mesh, mode="matfree")

        async def main():
            async with tqueue.SolveServer(max_batch=2, max_wait_ms=2.0, num_epochs=20,
                                          prepare_kwargs=kw) as server:
                fp = server.register(problem.A)
                return await server.submit(fp, problem.b), server.pool.resident()

        result, resident = _run(main())
        assert resident[0]["path"] == "matfree_sharded"
        want = tprepare(problem.A, **kw).solve(problem.b[:, None], num_epochs=20).x[:, 0]
        np.testing.assert_allclose(result.x, want, atol=1e-5)
        pool = tqueue.PreparedPool(**PORT_KW)
        fp = pool.register(problem.A, mesh=mesh, mode="matfree")
        assert pool.system(fp)[1]["mesh"] is mesh and not pool.has_fallback(fp)


# -- serving stats ------------------------------------------------------------


def _two_system_run(module, kw, problem, B):
    A2 = problem.A + np.float32(1e-3)

    async def main():
        async with module.SolveServer(max_batch=4, max_wait_ms=2.0, num_epochs=10,
                                      pool_size=1, prepare_kwargs=kw) as server:
            fa, fb = server.register(problem.A), server.register(A2)
            await asyncio.gather(*(
                server.submit(fa if i % 2 == 0 else fb, B[:, i % B.shape[1]])
                for i in range(12)))
            return server.stats()

    return _run(main())


def test_stats_schema_and_concurrent_counter_consistency(problem, rhs_batch):
    B, _ = rhs_batch
    stats = _two_system_run(tqueue, PORT_KW, problem, B)
    ref = _two_system_run(jqueue, JAX_KW, problem, B)
    assert set(stats) == set(ref) == STATS_SCHEMA
    assert stats["requests"] == 12
    assert stats["gets"] == stats["hits"] + stats["prepares"] + stats["restores"]
    assert stats["gets"] == stats["batches"]
    assert stats["misses"] == stats["prepares"] + stats["restores"]
    assert stats["evictions"] > 0


def test_reset_stats_is_registry_backed(problem, rhs_batch):
    B, _ = rhs_batch

    async def main():
        async with tqueue.SolveServer(max_batch=2, max_wait_ms=2.0, num_epochs=10,
                                      prepare_kwargs=PORT_KW) as server:
            fp = server.register(problem.A)
            await server.submit(fp, B[:, 0])
            before = server.stats()
            server.reset_stats()
            return before, server.stats(), server.render_metrics()

    before, after, text = _run(main())
    assert before["requests"] == 1 and after["requests"] == 0
    assert after["gets"] == before["gets"]
    assert "server_requests_total 0" in text
    assert "# TYPE pool_gets_total counter" in text


def _manual_replay(module, clock_module, trace_module, kw, problem, B):
    """Four requests in two full batches on a never-advanced ManualClock,
    traced: latencies, span records and the metrics text."""
    clk = clock_module.ManualClock()
    tracer = trace_module.Tracer(clock=clk)

    async def main():
        async with module.SolveServer(max_batch=2, num_epochs=10, prepare_kwargs=kw,
                                      clock=clk, tracer=tracer) as server:
            fp = server.register(problem.A)
            results = await asyncio.gather(*(server.submit(fp, B[:, i]) for i in range(4)))
            return results, server.render_metrics()

    results, text = _run(main())
    return results, tracer._records(), text


# what the port records that the reference does not: the batch's and the
# solver's phases, and the worker-idle histogram
PORT_ONLY_SPANS = ("batch.", "solver.")
PORT_ONLY_FAMILY = "server_worker_idle_ms"


def test_manual_clock_replay_equals_the_reference(problem, rhs_batch):
    """No wall clock leaks into the accounting: with a ManualClock that
    never moves, both packages report zero latencies, the same spans
    (names, tracks, times, attributes) and the same metrics text, once
    the port's own spans, links and histogram are set aside."""
    B, _ = rhs_batch
    ours = _manual_replay(tqueue, tclock, ttrace, PORT_KW, problem, B)
    ref = _manual_replay(jqueue, jclock, jtrace, JAX_KW, problem, B)
    for res in ours[0]:
        assert res.queue_ms == 0.0 and res.solve_ms == 0.0
        assert res.worker_idle_ms == 0.0
    assert [(r.queue_ms, r.solve_ms, r.batch_size, r.column, r.iterations) for r in ours[0]] == [
        (r.queue_ms, r.solve_ms, r.batch_size, r.column, r.iterations) for r in ref[0]]
    shared = [r for r in ours[1] if not r["name"].startswith(PORT_ONLY_SPANS)]
    assert _unlinked(shared) == ref[1]
    assert {r["name"] for r in ours[1]} - {r["name"] for r in shared} == {
        "batch.assemble", "batch.deliver", "solver.solve", "solver.rhs", "solver.init",
        "solver.epochs", "solver.wait", "solver.fetch", "solver.prepare",
        "solver.partition", "solver.qr", "solver.prepare_wait"}
    text = "\n".join(line for line in ours[2].split("\n") if PORT_ONLY_FAMILY not in line)
    assert text == ref[2]


# -- serving traces -----------------------------------------------------------


def test_server_trace_reconstructs_request_timelines(problem, rhs_batch, tmp_path):
    B, _ = rhs_batch
    tracer = ttrace.Tracer()

    async def main():
        async with tqueue.SolveServer(max_batch=2, max_wait_ms=2.0, num_epochs=10,
                                      prepare_kwargs=PORT_KW, tracer=tracer) as server:
            fp = server.register(problem.A)
            results = await tqueue.replay_trace(server, fp, B, [0.0] * B.shape[1])
            session = server.open_session(fp)
            await session.update(B[:, 0])
            await session.update(B[:, 1])
            return results

    _run(main())
    path = tmp_path / "trace.json"
    tracer.export_chrome(path)
    recs = jtrace.load_trace(path)  # the reference's reader
    request_ids = {r["trace_id"] for r in recs if r["cat"] == "request"}
    assert len(request_ids) == B.shape[1] + 2
    batches = [r for r in recs if r["name"] == "batch"]
    assert batches and all(b["trace_id"] == ttrace.SERVER_TRACK for b in batches)
    assert any(r["name"] == "pool.prepare" for r in recs)
    assert len([r for r in recs if r["name"] == "session.update"]) == 2
    for tid in request_ids:
        spans = {r["name"]: r for r in recs if r["trace_id"] == tid}
        queue, solve = spans["queue"], spans["solve"]
        assert queue["ts_us"] + queue["dur_us"] == pytest.approx(solve["ts_us"], abs=1.0)
        assert any(
            b["ts_us"] - 1.0 <= solve["ts_us"]
            and solve["ts_us"] + solve["dur_us"] <= b["ts_us"] + b["dur_us"] + 1.0
            and b["args"]["batch_size"] == solve["args"]["batch_size"]
            for b in batches
        )
    assert sum(b["args"]["batch_size"] for b in batches) == len(request_ids)


def test_serve_solver_cli_trace_read_by_the_reference_tools(tmp_path, capsys):
    """The port's command line writes both exports; the reference's
    ``load_trace`` and the unchanged ``tools/trace_report.py`` read them."""
    from repro_torch.launch.serve_solver import main

    chrome, jsonl = tmp_path / "serve.json", tmp_path / "serve.jsonl"
    main(["--requests", "8", "--rate", "500", "--n", "48", "--m", "96",
          "--num-blocks", "4", "--epochs", "15", "--device", "cpu",
          "--trace-out", str(chrome), "--trace-jsonl", str(jsonl)])
    out = capsys.readouterr().out
    assert "replayed 8 requests" in out and f"-> {jsonl} (jsonl)" in out
    for path in (chrome, jsonl):
        recs = jtrace.load_trace(path)
        request_ids = {r["trace_id"] for r in recs if r["cat"] == "request"}
        assert len(request_ids) == 8
        for tid in request_ids:
            assert {"queue", "solve"} <= {r["name"] for r in recs if r["trace_id"] == tid}
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        from trace_report import summarize
    finally:
        sys.path.remove(str(ROOT / "tools"))
    report = summarize(jtrace.load_trace(jsonl), top=2)
    assert "solve" in report and "queue" in report
    assert "batch sizes:" in report and "slowest 2 spans:" in report
