"""The port's serving queue and QoS policy against the JAX package's
(``tests/test_serving_queue.py`` and ``tests/test_serving_qos.py``, case by
case), on ``device="cpu"``.

What is held to the reference:

  * ``BatchPolicy.decide`` is a pure function and decides exactly as the
    reference's (a hypothesis property over pending states), and so do
    ``admit``, ``cap``, ``wait_s`` and the derived batch key;
  * ``matrix_fingerprint`` gives the reference's hex digest for the same
    dense array or ``COOMatrix``;
  * served solutions agree with the reference server's at 1e-4, with equal
    per-request iterations: the one-shot requests of a replay, and the warm
    updates of drifting session streams (a stream's first, cold update is
    compared at 1e-4 only, as ``tests/test_torch_session.py`` says why);
  * the server's own promises (results map to their requests, the wait
    window flushes, a full batch does not wait, the LRU pool evicts and
    re-prepares, interactive requests overtake bulk, admission control,
    tolerance-split batches, a restore mid-session) hold as the reference
    tests state them.

Small sizes: n = 96, m = 384 and n = 48, m = 192, J = 8, as the
reference's tests.
"""
import asyncio
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given
from hypothesis import strategies as st

from repro.serving import policy as jpolicy
from repro.serving import queue as jqueue
from repro.sparse import matrix as jmatrix
from repro_torch.core import prepare
from repro_torch.core.prepared import SolveOptions
from repro_torch.serving import policy as tpolicy
from repro_torch.serving import queue as tqueue
from repro_torch.serving.policy import (
    _BATCH_KEY_FIELDS,
    AdmissionError,
    BatchPolicy,
    Priority,
    SubmitOptions,
    batch_key,
)
from repro_torch.serving.queue import (
    PreparedPool,
    SolveServer,
    matrix_fingerprint,
    replay_trace,
)
from repro_torch.sparse import generate_schenk_like, make_problem
from repro_torch.sparse import matrix as tmatrix

EPOCHS = 150
JAX_KW = dict(num_blocks=8, materialize_p=False)
PREP_KW = dict(JAX_KW, device="cpu")


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
    xs = rng.standard_normal((96, 10)).astype(np.float32)
    return problem.A @ xs, xs


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


# -- BatchPolicy: the pure decision, against the reference's ----------------


class _Item:
    def __init__(self, t_enqueue, deadline_at=None):
        self.t_enqueue = t_enqueue
        self.deadline_at = deadline_at


def _pending(module, bulk=(), interactive=()):
    P = module.Priority
    return {P.INTERACTIVE: list(interactive), P.BULK: list(bulk)}


def _decision(out):
    priority, reason, wake = out
    return (None if priority is None else priority.name, reason, wake)


_ITEMS = st.lists(
    st.tuples(
        st.floats(min_value=0.0, max_value=1.0, allow_nan=False),
        st.none() | st.floats(min_value=0.0, max_value=1.2, allow_nan=False),
    ),
    max_size=6,
)


@given(
    bulk=_ITEMS, interactive=_ITEMS,
    now=st.floats(min_value=0.0, max_value=1.5, allow_nan=False),
    solve_s=st.floats(min_value=0.0, max_value=0.3, allow_nan=False),
    draining=st.booleans(),
    max_batch=st.integers(1, 5),
    max_wait_ms=st.floats(min_value=0.0, max_value=200.0, allow_nan=False),
    interactive_max_batch=st.none() | st.integers(1, 5),
    interactive_max_wait_ms=st.floats(min_value=0.0, max_value=50.0, allow_nan=False),
)
def test_decide_equals_the_reference(bulk, interactive, now, solve_s, draining, max_batch,
                                     max_wait_ms, interactive_max_batch,
                                     interactive_max_wait_ms):
    """Every pending state gets the reference's decision: which class
    flushes, why, and when to wake otherwise."""
    kw = dict(max_batch=max_batch, max_wait_ms=max_wait_ms,
              interactive_max_batch=interactive_max_batch,
              interactive_max_wait_ms=interactive_max_wait_ms)
    got, want = [
        _decision(module.BatchPolicy(**kw).decide(
            now,
            _pending(module, [_Item(*i) for i in bulk], [_Item(*i) for i in interactive]),
            solve_s=solve_s, draining=draining))
        for module in (tpolicy, jpolicy)
    ]
    assert got == want


def test_decide_contract_cases():
    """The reference tests' cases: idle and waiting, each flush reason, the
    deadline pull-forward by the solve estimate, strictly interactive
    first."""
    policy = BatchPolicy(max_batch=4, max_wait_ms=10.0)
    assert policy.decide(0.0, _pending(tpolicy)) == (None, None, None)
    priority, reason, wake = policy.decide(1.0, _pending(tpolicy, bulk=[_Item(1.0)]))
    assert priority is None and reason is None and wake == pytest.approx(1.010)
    policy = BatchPolicy(max_batch=2, max_wait_ms=10.0)
    assert policy.decide(0.0, _pending(tpolicy, bulk=[_Item(0.0)] * 2))[:2] == (
        Priority.BULK, "full")
    late = _pending(tpolicy, bulk=[_Item(0.0)])
    assert policy.decide(0.5, late)[:2] == (Priority.BULK, "timeout")
    assert policy.decide(0.0, late, draining=True)[:2] == (Priority.BULK, "drain")
    policy = BatchPolicy(max_batch=8, max_wait_ms=100.0)
    queue = _pending(tpolicy, bulk=[_Item(0.0, deadline_at=0.05)])
    priority, _, wake = policy.decide(0.0, queue, solve_s=0.03)
    assert priority is None and wake == pytest.approx(0.02)
    assert policy.decide(0.021, queue, solve_s=0.03)[:2] == (Priority.BULK, "deadline")
    policy = BatchPolicy(max_batch=2, max_wait_ms=10.0)
    queue = _pending(tpolicy, bulk=[_Item(0.0)] * 2, interactive=[_Item(5.0)])
    assert policy.decide(5.0, queue)[:2] == (Priority.INTERACTIVE, "timeout")


def test_policy_caps_waits_admission_and_validation():
    kw = dict(max_batch=8, max_wait_ms=4.0, interactive_max_batch=2,
              interactive_max_wait_ms=1.0, max_pending_bulk=3)
    ours, ref = BatchPolicy(**kw), jpolicy.BatchPolicy(**kw)
    for p, q in zip(Priority, jpolicy.Priority):
        assert (p.name, p.value) == (q.name, q.value)
        assert ours.cap(p) == ref.cap(q) and ours.wait_s(p) == ref.wait_s(q)
    assert BatchPolicy(max_batch=5).cap(Priority.INTERACTIVE) == 5
    with pytest.raises(ValueError, match="max_batch"):
        BatchPolicy(max_batch=0)
    with pytest.raises(ValueError, match="interactive_max_batch"):
        BatchPolicy(interactive_max_batch=0)
    ours.admit(Priority.BULK, bulk_backlog=2)
    with pytest.raises(AdmissionError):
        ours.admit(Priority.BULK, bulk_backlog=3)
    ours.admit(Priority.INTERACTIVE, bulk_backlog=100)
    BatchPolicy().admit(Priority.BULK, bulk_backlog=10**6)


def test_batch_key_derivation_matches_the_reference():
    assert _BATCH_KEY_FIELDS == jpolicy._BATCH_KEY_FIELDS == ("tol",)
    assert SubmitOptions.field_names() == jpolicy.SubmitOptions.field_names()
    assert set(_BATCH_KEY_FIELDS) <= set(SolveOptions.field_names())
    a = SubmitOptions(priority=Priority.INTERACTIVE, deadline_ms=5.0)
    b = SubmitOptions(x0=np.ones(3))
    assert batch_key(a) == batch_key(b) == batch_key(SubmitOptions())
    assert batch_key(SubmitOptions(tol=1e-5)) != batch_key(SubmitOptions())
    assert SubmitOptions() == SubmitOptions(
        priority=Priority.BULK, deadline_ms=None, tol=None, x0=None)


# -- fingerprints ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fingerprint_equals_the_reference(problem, dtype):
    A = problem.A.astype(dtype)
    assert matrix_fingerprint(A) == jqueue.matrix_fingerprint(A)
    assert matrix_fingerprint(A[:, ::2]) == jqueue.matrix_fingerprint(A[:, ::2])
    coo = generate_schenk_like(96, seed=4)
    jcoo = jmatrix.COOMatrix(coo.rows, coo.cols, coo.vals.astype(dtype), coo.shape)
    tcoo = tmatrix.COOMatrix(coo.rows, coo.cols, coo.vals.astype(dtype), coo.shape)
    assert matrix_fingerprint(tcoo) == jqueue.matrix_fingerprint(jcoo)
    assert matrix_fingerprint(tcoo) != matrix_fingerprint(tcoo.to_dense())


# -- served solutions against the reference server's ---------------------------


def _replay(module, kw, A, B, tol, max_batch=4):
    async def main():
        async with module.SolveServer(max_batch=max_batch, max_wait_ms=5.0, num_epochs=EPOCHS,
                                      tol=tol, prepare_kwargs=kw) as server:
            fp = server.register(A)
            return await module.replay_trace(server, fp, B, np.full(B.shape[1], 1e-4))

    return _run(main())


def test_served_solutions_match_the_reference(problem, rhs_batch):
    """The same requests through both servers: each answer the solution of
    its own b, within 1e-4 of the reference's, in as many epochs. The tol,
    1e-2, lies 36x above the cold residual floor (2.8e-4); at 1e-3, within
    4x of it, two of ten counts move by one epoch either way."""
    B, xs = rhs_batch
    ours = _replay(tqueue, PREP_KW, problem.A, B, tol=1e-2)
    ref = _replay(jqueue, JAX_KW, problem.A, B, tol=1e-2)
    for i, (o, r) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(o.x, xs[:, i], atol=1e-3)
        np.testing.assert_allclose(o.x, np.asarray(r.x), atol=1e-4)
        assert o.iterations == r.iterations < EPOCHS and o.converged


def _drift(A, cols, updates, amp=2e-3, seed=2):
    n = A.shape[1]
    x_base = np.random.default_rng(seed).standard_normal((n, cols)).astype(np.float32)
    phase = np.arange(n)[:, None]
    return [(A @ (x_base + amp * np.sin(0.25 * t + phase))).astype(np.float32)
            for t in range(updates)]


def _streams(module, kw, system, bs, tol, num_epochs):
    async def main():
        async with module.SolveServer(max_batch=bs[0].shape[1], max_wait_ms=5.0,
                                      num_epochs=num_epochs, tol=tol,
                                      prepare_kwargs=kw) as server:
            fp = server.register(system)
            sessions = [server.open_session(fp) for _ in range(bs[0].shape[1])]
            out = []
            for b in bs:
                out.append(await asyncio.gather(
                    *(s.update(b[:, i]) for i, s in enumerate(sessions))))
            return out, [s.total_iterations for s in sessions], server.stats()

    return _run(main())


@pytest.mark.parametrize("path", ["dense", "matfree"])
def test_drifting_sessions_match_the_reference(problem, path):
    """Drifting streams as concurrent ServerSessions of one column each:
    every update within 1e-4 of the reference server's, warm updates in as
    many epochs, each update's columns coalesced into one batch."""
    if path == "dense":
        system = jsystem = A = problem.A
        kw, tol, cap = dict(JAX_KW), 0.05, EPOCHS
    else:
        system = generate_schenk_like(192, seed=9)
        jsystem = jmatrix.COOMatrix(system.rows, system.cols, system.vals, system.shape)
        A = system.to_dense().astype(np.float32)
        kw, tol, cap = dict(mode="matfree", num_blocks=8, gamma=2.0, eta=1.9), 0.05, 300
    bs = _drift(A, cols=4, updates=5)
    ours, totals, stats = _streams(tqueue, dict(kw, device="cpu"), system, bs, tol, cap)
    ref, ref_totals, _ = _streams(jqueue, kw, jsystem, bs, tol, cap)
    assert stats["batches"] == len(bs) and stats["requests"] == 4 * len(bs)
    for t, (o_upd, r_upd) in enumerate(zip(ours, ref)):
        for o, r in zip(o_upd, r_upd):
            np.testing.assert_allclose(o.x, np.asarray(r.x), atol=1e-4)
            if t > 0:  # warm updates; the cold first one near the float floor
                assert o.iterations == r.iterations
    warm = [sum(o.iterations for o in upd) for upd in ours[1:]]
    assert sum(warm) < 0.7 * sum(o.iterations for o in ours[0]) * len(warm)
    assert sum(totals) - sum(ref_totals) == sum(
        o.iterations - r.iterations for o, r in zip(ours[0], ref[0]))


# -- queue semantics (tests/test_serving_queue.py) -----------------------------


def test_out_of_order_arrivals_map_to_their_futures(problem, rhs_batch):
    B, xs = rhs_batch
    k = xs.shape[1]
    order = np.random.default_rng(5).permutation(k)

    async def main():
        async with SolveServer(max_batch=4, max_wait_ms=10.0, num_epochs=EPOCHS,
                               prepare_kwargs=PREP_KW) as server:
            fp = server.register(problem.A)

            async def client(i, delay):
                await asyncio.sleep(delay)
                return i, await server.submit(fp, B[:, i])

            results = await asyncio.gather(
                *(client(int(i), 0.002 * pos) for pos, i in enumerate(order)))
            return results, server.stats()

    results, stats = _run(main())
    assert len(results) == k
    for i, res in results:
        np.testing.assert_allclose(res.x, xs[:, i], atol=1e-3)
        assert res.residual_sq < 1e-3 and 1 <= res.batch_size <= 4 and 0 <= res.column < 4
    assert stats["requests"] == k and stats["batches"] >= -(-k // 4)


@pytest.mark.parametrize("max_batch,wait_ms,count,sizes", [
    (64, 20.0, 3, [3, 3, 3]),  # the window flushes a partial batch
    (4, 60_000.0, 4, [4, 4, 4, 4]),  # a full batch does not wait it out
])
def test_flush_on_window_or_full_batch(problem, rhs_batch, max_batch, wait_ms, count, sizes):
    B, xs = rhs_batch

    async def main():
        async with SolveServer(max_batch=max_batch, max_wait_ms=wait_ms, num_epochs=EPOCHS,
                               prepare_kwargs=PREP_KW) as server:
            fp = server.register(problem.A)
            results = await asyncio.gather(*(server.submit(fp, B[:, i]) for i in range(count)))
            return results, server.stats()

    results, stats = _run(main())
    assert [r.batch_size for r in results] == sizes
    assert sorted(r.column for r in results) == list(range(count))
    if count < max_batch:
        assert stats["timeout_flushes"] >= 1 and stats["full_batches"] == 0
    for i, res in enumerate(results):
        np.testing.assert_allclose(res.x, xs[:, i], atol=1e-3)


def test_submit_validates_shape_and_system(problem):
    async def main():
        async with SolveServer(prepare_kwargs=PREP_KW) as server:
            fp = server.register(problem.A)
            with pytest.raises(ValueError, match="rhs shape"):
                await server.submit(fp, np.zeros(7, np.float32))
            with pytest.raises(KeyError):
                await server.submit("deadbeef", problem.b)

    _run(main())


def test_pool_lru_eviction_and_reprepare():
    probs = [make_problem(n=32, m=128, seed=s, dtype=np.float32) for s in (1, 2, 3)]
    pool = PreparedPool(max_size=2, **PREP_KW)
    fps = [pool.register(p.A) for p in probs]
    assert len(set(fps)) == 3 and fps[0] == matrix_fingerprint(probs[0].A)
    pool.get(fps[0])
    pool.get(fps[1])
    assert pool.stats.prepares == 2 and len(pool) == 2
    pool.get(fps[0])
    assert pool.stats.hits == 1
    pool.get(fps[2])
    assert pool.stats.evictions == 1
    assert fps[0] in pool and fps[2] in pool and fps[1] not in pool
    pool.get(fps[1])
    assert pool.stats.prepares == 4
    assert {e["path"] for e in pool.resident()} == {"dense"}
    assert all(str(pool.get(fp).device) == "cpu" for fp in fps[1:])


def test_pool_counters_hold_under_thread_stress():
    """More threads than cores hammer one small pool (register, get, evict)
    with a shortened switch interval: every get resolves exactly one way
    (gets == hits + prepares + restores), the LRU bound holds, and no entry
    leaves without being counted."""
    import os
    import sys
    import threading

    probs = [make_problem(n=16, m=64, seed=s, dtype=np.float32).A for s in range(3)]
    pool = PreparedPool(max_size=2, num_blocks=4, device="cpu")
    fps = [pool.register(A) for A in probs]
    workers = 2 * (os.cpu_count() or 2) + 1
    errors = []

    def work(i):
        try:
            for j in range(6):
                assert pool.register(probs[(i + j) % 3]) == fps[(i + j) % 3]
                pool.get(fps[(i * 7 + j) % 3])
        except Exception as exc:  # reported below, with the worker's index
            errors.append((i, exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    st = pool.stats
    assert st.gets == workers * 6 == st.hits + st.prepares + st.restores
    # two threads that miss one system together both prepare it, and the
    # later entry replaces the earlier without an eviction (as the reference)
    assert len(pool) <= 2 and st.evictions + len(pool) <= st.prepares


def test_eviction_does_not_break_inflight_solver():
    probs = [make_problem(n=32, m=128, seed=s, dtype=np.float32) for s in (4, 5, 6)]
    pool = PreparedPool(max_size=1, **PREP_KW)
    fps = [pool.register(p.A) for p in probs]
    inflight = pool.get(fps[0])
    pool.get(fps[1])
    pool.get(fps[2])
    assert fps[0] not in pool
    res = inflight.solve(probs[0].b, num_epochs=200)
    np.testing.assert_allclose(res.x, probs[0].x_true, atol=1e-3)


def test_server_interleaves_multiple_systems_with_tiny_pool():
    pa = make_problem(n=48, m=192, seed=7, dtype=np.float32)
    pb = make_problem(n=48, m=192, seed=8, dtype=np.float32)
    rng = np.random.default_rng(9)
    xa = rng.standard_normal((48, 4)).astype(np.float32)
    xb = rng.standard_normal((48, 4)).astype(np.float32)
    Ba, Bb = pa.A @ xa, pb.A @ xb

    async def main():
        async with SolveServer(max_batch=4, max_wait_ms=10.0, num_epochs=EPOCHS, pool_size=1,
                               prepare_kwargs=PREP_KW) as server:
            fa, fb = server.register(pa.A), server.register(pb.A)
            jobs = []
            for i in range(4):
                jobs.append(server.submit(fa, Ba[:, i]))
                jobs.append(server.submit(fb, Bb[:, i]))
            return await asyncio.gather(*jobs), server.pool.stats

    results, stats = _run(main())
    for i in range(4):
        np.testing.assert_allclose(results[2 * i].x, xa[:, i], atol=1e-3)
        np.testing.assert_allclose(results[2 * i + 1].x, xb[:, i], atol=1e-3)
    assert stats.evictions >= 1


def test_replay_trace_returns_request_order(problem, rhs_batch):
    B, xs = rhs_batch

    async def main():
        async with SolveServer(max_batch=8, max_wait_ms=5.0, num_epochs=EPOCHS,
                               prepare_kwargs=PREP_KW) as server:
            fp = server.register(problem.A)
            return await replay_trace(server, fp, B, np.full(xs.shape[1], 1e-4))

    for i, res in enumerate(_run(main())):
        np.testing.assert_allclose(res.x, xs[:, i], atol=1e-3)


def test_bucket_pad_solves_at_one_width(problem, rhs_batch):
    """Zero-padded columns never perturb real ones: a padded partial batch
    returns what the same columns solve to unpadded, and the server reports
    only the real requests."""
    B, _ = rhs_batch
    got = {}
    for pad in (True, False):
        async def main():
            async with SolveServer(max_batch=8, max_wait_ms=5.0, num_epochs=EPOCHS,
                                   bucket_pad=pad, prepare_kwargs=PREP_KW) as server:
                fp = server.register(problem.A)
                return await asyncio.gather(*(server.submit(fp, B[:, i]) for i in range(3)))

        got[pad] = _run(main())
    for a, b in zip(got[True], got[False]):
        assert a.batch_size == b.batch_size == 3
        np.testing.assert_allclose(a.x, b.x, atol=1e-6)


# -- QoS end to end (tests/test_serving_qos.py) --------------------------------


def test_solve_options_positional_form_matches_kwargs(problem):
    prep = prepare(problem.A, **PREP_KW)
    opts = SolveOptions(num_epochs=25, tol=1e-4)
    ref = prep.solve(problem.b, num_epochs=25, tol=1e-4)
    got = prep.solve(problem.b, opts)
    assert np.array_equal(ref.x, got.x) and ref.num_epochs == got.num_epochs
    with pytest.raises(dataclasses.FrozenInstanceError):
        opts.num_epochs = 1


def test_interactive_overtakes_bulk_flood():
    prob = make_problem(n=48, m=192, seed=51, dtype=np.float32)
    rng = np.random.default_rng(53)
    xs = rng.standard_normal((48, 13)).astype(np.float32)
    B = prob.A @ xs
    done: list[str] = []

    async def main():
        async with SolveServer(max_batch=4, max_wait_ms=5.0, num_epochs=150,
                               prepare_kwargs=PREP_KW) as server:
            fp = server.register(prob.A)
            await server.submit(fp, B[:, 0])
            server.reset_stats()

            async def bulk(i):
                res = await server.submit(fp, B[:, i])
                done.append(f"bulk{i}")
                return i, res

            async def interactive():
                await asyncio.sleep(0.01)
                res = await server.submit(fp, B[:, 12],
                                          SubmitOptions(priority=Priority.INTERACTIVE))
                done.append("interactive")
                return 12, res

            results = await asyncio.gather(*(bulk(i) for i in range(12)), interactive())
            return results, server.stats()

    results, stats = _run(main())
    for i, res in results:
        np.testing.assert_allclose(res.x, xs[:, i], atol=1e-3)
    assert stats["interactive_batches"] >= 1 and stats["bulk_batches"] >= 3
    assert done.index("interactive") < len(done) - 1, done


def test_admission_control_rejects_deterministically():
    prob = make_problem(n=48, m=192, seed=57, dtype=np.float32)
    rng = np.random.default_rng(59)
    xs = rng.standard_normal((48, 9)).astype(np.float32)
    B = prob.A @ xs

    async def main():
        policy = BatchPolicy(max_batch=4, max_wait_ms=5.0, max_pending_bulk=4)
        async with SolveServer(num_epochs=150, prepare_kwargs=PREP_KW, policy=policy) as server:
            fp = server.register(prob.A)
            tasks = [asyncio.create_task(server.submit(fp, B[:, i])) for i in range(8)]
            inter = asyncio.create_task(server.submit(
                fp, B[:, 8], SubmitOptions(priority=Priority.INTERACTIVE)))
            return await asyncio.gather(*tasks, inter, return_exceptions=True), server.stats()

    results, stats = _run(main())
    rejected = [r for r in results if isinstance(r, AdmissionError)]
    served = [r for r in results if not isinstance(r, Exception)]
    assert len(rejected) == 4 and len(served) == 5 and stats["admission_rejects"] == 4
    for i, res in zip((0, 1, 2, 3, 8), served):
        np.testing.assert_allclose(res.x, xs[:, i], atol=1e-3)


def test_per_request_tol_splits_batches():
    prob = make_problem(n=48, m=192, seed=61, dtype=np.float32)
    rng = np.random.default_rng(63)
    xs = rng.standard_normal((48, 4)).astype(np.float32)
    B = prob.A @ xs

    async def main():
        async with SolveServer(max_batch=8, max_wait_ms=20.0, num_epochs=150,
                               prepare_kwargs=PREP_KW) as server:
            fp = server.register(prob.A)
            loose = SubmitOptions(tol=1e-2)
            results = await asyncio.gather(
                server.submit(fp, B[:, 0]), server.submit(fp, B[:, 1], loose),
                server.submit(fp, B[:, 2]), server.submit(fp, B[:, 3], loose))
            return results, server.stats()

    results, stats = _run(main())
    assert stats["batches"] == 2
    assert [r.batch_size for r in results] == [2, 2, 2, 2]
    for i, res in enumerate(results):
        np.testing.assert_allclose(res.x, xs[:, i], atol=1e-2)


def test_eviction_then_warm_restore_mid_session(tmp_path):
    pa = make_problem(n=48, m=192, seed=71, dtype=np.float32)
    pb = make_problem(n=48, m=192, seed=72, dtype=np.float32)

    async def main():
        async with SolveServer(max_batch=4, max_wait_ms=5.0, num_epochs=150, tol=1e-4,
                               pool_size=1, checkpoint=str(tmp_path),
                               prepare_kwargs=PREP_KW) as server:
            fa, fb = server.register(pa.A), server.register(pb.A)
            session = server.open_session(fa)
            r0 = await session.update(pa.b)
            await server.submit(fb, pb.b)
            assert fa not in server.pool
            r1 = await session.update(pa.b)
            return (r0, r1), server.stats()

    (r0, r1), stats = _run(main())
    np.testing.assert_allclose(r0.x, pa.x_true, atol=1e-3)
    np.testing.assert_allclose(r1.x, pa.x_true, atol=1e-3)
    assert stats["prepares"] == 2 and stats["restores"] == 1 and stats["misses"] == 3
    assert stats["restore_ms"] > 0.0
    assert r1.iterations <= r0.iterations


def test_submit_options_default_shim_is_bulk_fifo():
    prob = make_problem(n=48, m=192, seed=81, dtype=np.float32)

    async def main():
        async with SolveServer(max_batch=4, max_wait_ms=5.0, num_epochs=150,
                               prepare_kwargs=PREP_KW) as server:
            fp = server.register(prob.A)
            results = await asyncio.gather(*(server.submit(fp, prob.b) for _ in range(4)))
            return results, server.stats()

    results, stats = _run(main())
    assert stats["interactive_batches"] == 0 and stats["admission_rejects"] == 0
    assert stats["bulk_batches"] == stats["batches"] >= 1
    for res in results:
        np.testing.assert_allclose(res.x, prob.x_true, atol=1e-3)


def test_serve_solver_cli_report_lines(capsys):
    """The port's command line prints the reference's report lines, for
    both traces, on the CPU when asked."""
    from repro_torch.launch import serve_solver

    serve_solver.main(["--n", "64", "--m", "256", "--epochs", "60", "--requests", "12",
                       "--rate", "400", "--device", "cpu", "--kernels"])
    out = capsys.readouterr().out.splitlines()
    heads = ["system 256x64 method=dapc J=8 epochs=60", "replayed 12 requests at ~400 req/s",
             "latency ms: p50=", "batches: ", "pool: hits=", "accuracy: max|x - x_true| = ",
             "pool: system "]
    assert [line for line, head in zip(out, heads) if line.startswith(head)] == out[:7]
    assert "unconverged columns (tol=0.001): 0" in out[5]
    serve_solver.main(["--n", "64", "--m", "256", "--epochs", "60", "--trace", "drifting",
                       "--sessions", "2", "--updates", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    for line, head in zip(out, ["system 256x64 method=dapc J=8 epochs<=60 tol=0.001",
                                "replayed 2 drifting streams x 4 updates", "epochs/update: cold(first)=",
                                "batches: "]):
        assert line.startswith(head), (line, head)
    # --mesh (the multi-device slice; tests/test_torch_mesh_ranks.py serves
    # through it) checks its arguments as the reference does, before any rank
    for bad in (["--mesh", "2"], ["--mode", "matfree", "--num-blocks", "8", "--mesh", "3"]):
        with pytest.raises(SystemExit):
            serve_solver.main(bad + ["--device", "cpu"])
    assert "--mesh" in capsys.readouterr().err
