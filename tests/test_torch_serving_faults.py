"""The port's fault injection and containment ladder against the JAX
package's (``tests/test_faults.py``, case by case), on ``device="cpu"``.

Held to the reference: a ``FaultPlan`` serializes to the reference's JSON
and reads it back; a seeded plan fires on the same calls and so poisons the
same request sequence numbers in both packages, down to the request a
server fails. The ladder's own promises hold as the reference tests state
them: a poisoned request is isolated from its batchmates, transient faults
recover, the watchdog's NaN/stall verdicts enter the ladder, the fallback
re-prepare keeps the registration's ``device`` and ``use_kernels``, the
circuit breaker opens and heals on the injected clock, a timeout bounds
the ladder, a cancelled request cannot poison its batch, and the
checkpoint store quarantines damaged files only.

Two cases are the port's own: a device that refuses a restored state
raises instead of quarantining the file, and the torn-write check orders
its writers and reader with ``threading.Event``s, so that it cannot be
flaky (the reference's timing-dependent counterpart stays as it is).
"""
import asyncio
import io
import threading

import numpy as np
import pytest
import torch

from repro.serving import faults as jfaults
from repro.serving import queue as jqueue
from repro_torch.core import Watchdog, prepare
from repro_torch.obs.clock import ManualClock
from repro_torch.serving import checkpoint as tcheckpoint
from repro_torch.serving import faults as tfaults
from repro_torch.serving import queue as tqueue
from repro_torch.serving.checkpoint import CheckpointStore
from repro_torch.serving.faults import (
    FaultPlan,
    FaultRule,
    InjectedFault,
    SolveFailure,
)
from repro_torch.serving.policy import SubmitOptions
from repro_torch.serving.queue import PreparedPool, SolveServer, matrix_fingerprint
from repro_torch.sparse import generate_schenk_like, make_problem

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


@pytest.fixture(scope="module")
def prepared(problem):
    return prepare(problem.A, **PREP_KW)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


def _injector(*rules, seed=0, clock=None, module=tfaults):
    return module.FaultInjector(module.FaultPlan(rules=tuple(rules), seed=seed), clock=clock)


# -- the plan: serialization and determinism, against the reference ----------

_RULES = (
    dict(site="solve", kind="error", request=7),
    dict(site="checkpoint.load", kind="corrupt", times=1),
    dict(site="solve", kind="nan", request=3, prob=0.5, delay_s=0.25),
    dict(site="solve", kind="error", request=6, times=1),
    dict(site="solve", kind="error", request=8, path="matfree"),
    dict(site="prepare", kind="error"),
    dict(site="solve", kind="stall", request=5),
)


def test_fault_plan_json_matches_the_reference(tmp_path):
    ours = FaultPlan(rules=_RULES, seed=42)
    ref = jfaults.FaultPlan(rules=_RULES, seed=42)
    assert ours.to_json() == ref.to_json()
    assert FaultPlan.from_json(ref.to_json()) == ours
    f = tmp_path / "plan.json"
    f.write_text(ref.to_json())
    assert FaultPlan.load(f) == ours
    assert ours.rules[0] == FaultRule(site="solve", kind="error", request=7)
    assert ours.poisoned_requests == ref.poisoned_requests == frozenset({5, 7})


@pytest.mark.parametrize("seed", [0, 7, 8, 2306])
def test_seeded_plan_fires_as_the_reference(seed):
    """The same plan over the same call sequence fires on the same calls in
    both packages: probabilistic rules draw from the same per-rule numpy
    generators, windows count the same matches."""
    rules = (
        dict(site="solve", kind="error", prob=0.5),
        dict(site="solve", kind="nan", request=9, prob=0.7),
        dict(site="solve", kind="stall", after=3, times=4),
    )

    def pattern(module):
        inj = module.FaultInjector(module.FaultPlan(rules=rules, seed=seed))
        out = []
        for i in range(40):
            try:
                out.append(("ok", inj.on_solve("fp", (i, i + 9 - 9 * (i % 2)))))
            except module.InjectedFault:
                out.append(("error", i))
        return out, inj.stats(), inj.fired_total

    ours, ref = pattern(tfaults), pattern(jfaults)
    assert ours == ref
    assert any(kind == "error" for kind, _ in ours[0]) and ours[2] > 0


def test_after_and_times_windows():
    inj = _injector(FaultRule(site="prepare", kind="error", after=1, times=2))
    inj.on_prepare("fp")
    for _ in range(2):
        with pytest.raises(InjectedFault):
            inj.on_prepare("fp")
    inj.on_prepare("fp")
    assert inj.fired_total == 2
    (st,) = inj.stats()
    assert st["matches"] == 4 and st["fires"] == 2


def test_delay_advances_manual_clock_without_sleeping():
    clock = ManualClock()
    inj = _injector(FaultRule(site="prepare", kind="delay", delay_s=1.5), clock=clock)
    t0 = clock.now()
    inj.on_prepare("fp")
    assert clock.now() - t0 == pytest.approx(1.5)


# -- containment --------------------------------------------------------------


def _poison_run(module, kw, A, B, k=6):
    async def main():
        async with module.SolveServer(max_batch=k, max_wait_ms=20.0, num_epochs=EPOCHS,
                                      prepare_kwargs=kw) as server:
            fp = server.register(A)
            poison = server.next_request_seq + 2
            server.faults = server.pool.faults = _injector(
                dict(site="solve", kind="error", request=poison),
                module=jfaults if module is jqueue else tfaults)
            results = await asyncio.gather(
                *(server.submit(fp, B[:, i]) for i in range(k)), return_exceptions=True)
            return results, server.stats(), poison

    return _run(main())


def test_poison_request_is_isolated_as_in_the_reference(problem, rhs_batch):
    """One persistent poison in a batch of six: both packages fail exactly
    the targeted request (same seq, same slot, same reason) after the same
    bisection, and answer every batchmate with its own solution."""
    B, xs = rhs_batch
    results, stats, poison = _poison_run(tqueue, PREP_KW, problem.A, B)
    ref, ref_stats, ref_poison = _poison_run(jqueue, JAX_KW, problem.A, B)
    failures = [r for r in results if isinstance(r, BaseException)]
    (failure,) = failures
    (ref_failure,) = [r for r in ref if isinstance(r, BaseException)]
    assert isinstance(failure, SolveFailure) and failure.reason == "error"
    assert (failure.request, failure.reason, failure.attempts, results.index(failure)) == (
        ref_failure.request, ref_failure.reason, ref_failure.attempts, ref.index(ref_failure))
    assert failure.request == poison == ref_poison and results.index(failure) == 2
    for i, res in enumerate(results):
        if i != 2:
            np.testing.assert_allclose(res.x, xs[:, i], atol=1e-3)
    for key in ("failed_requests", "recovered_requests", "requests", "retries", "failures",
                "batches"):
        assert stats[key] == ref_stats[key], key
    assert stats["failed_requests"] == 1 and stats["requests"] == 5 and stats["retries"] >= 2


@pytest.mark.parametrize("site,kind", [("solve", "error"), ("prepare", "error"),
                                       ("solve", "nan"), ("solve", "stall")])
def test_transient_fault_recovers(problem, rhs_batch, site, kind):
    """A one-shot fault on a lone request recovers on the ladder's retry;
    NaN and stall faults are the watchdog's to flag."""
    B, xs = rhs_batch

    async def main():
        async with SolveServer(max_batch=1, max_wait_ms=5.0, num_epochs=EPOCHS,
                               prepare_kwargs=PREP_KW, watchdog=Watchdog()) as server:
            fp = server.register(problem.A)
            rule = dict(site=site, kind=kind, times=1)
            if site == "solve":
                rule["request"] = server.next_request_seq
            server.faults = server.pool.faults = _injector(FaultRule(**rule))
            res = await server.submit(fp, B[:, 0])
            return res, server.stats()

    res, stats = _run(main())
    np.testing.assert_allclose(res.x, xs[:, 0], atol=1e-3)
    assert stats["recovered_requests"] == 1 and stats["failed_requests"] == 0
    assert stats["failures"] >= 1
    assert res.attempts == 2


def test_watchdog_flags_only_the_nan_column(problem, rhs_batch):
    B, xs = rhs_batch

    async def main():
        async with SolveServer(max_batch=4, max_wait_ms=20.0, num_epochs=EPOCHS,
                               prepare_kwargs=PREP_KW, watchdog=Watchdog()) as server:
            fp = server.register(problem.A)
            sick = server.next_request_seq + 1
            server.faults = server.pool.faults = _injector(
                FaultRule(site="solve", kind="nan", request=sick, times=1))
            results = await asyncio.gather(*(server.submit(fp, B[:, i]) for i in range(4)))
            nan = server.metrics.value("server_failures_total", reason="nan")
            return results, server.stats(), nan

    results, stats, nan = _run(main())
    for i, res in enumerate(results):
        np.testing.assert_allclose(res.x, xs[:, i], atol=1e-3)
        assert np.isfinite(res.x).all()
    assert [r.attempts for r in results] == [1, 2, 1, 1]
    assert nan == 1 and stats["recovered_requests"] == 1 and stats["failed_requests"] == 0


def test_matfree_fault_escalates_to_dense_fallback_on_the_same_device():
    """A fault pinned to the matrix-free path outlives the retry; the
    fallback re-prepare (matfree → dense) recovers it and the pool keeps
    the dense solver, prepared with the registration's device and
    use_kernels."""
    coo = generate_schenk_like(256, sparsity=0.99, seed=5)
    rng = np.random.default_rng(11)
    x_true = rng.standard_normal(256).astype(np.float32)
    b = coo.to_dense().astype(np.float32) @ x_true

    async def main():
        async with SolveServer(max_batch=1, max_wait_ms=5.0, num_epochs=400,
                               prepare_kwargs=dict(mode="matfree", num_blocks=8, device="cpu",
                                                   use_kernels=True)) as server:
            fp = server.register(coo)
            server.faults = server.pool.faults = _injector(
                FaultRule(site="solve", kind="error", path="matfree"))
            first = await server.submit(fp, b)
            second = await server.submit(fp, b)
            return (first, second, server.stats(), server.pool.resident(),
                    server.pool.get(fp), server.pool._systems[fp][1])

    first, second, stats, resident, prep, kwargs = _run(main())
    np.testing.assert_allclose(first.x, second.x, atol=1e-6)
    assert first.residual_sq < 1e-2 * float(b @ b)
    assert (first.attempts, second.attempts) == (3, 1)
    assert stats["recovered_requests"] == 1 and stats["failed_requests"] == 0
    (entry,) = resident
    assert entry["path"] == "dense"
    assert kwargs["mode"] == "dense" and kwargs["device"] == "cpu" and kwargs["use_kernels"]
    assert str(prep.device) == "cpu" and prep.use_kernels


def test_circuit_breaker_opens_fast_fails_and_heals(problem, rhs_batch):
    B, xs = rhs_batch
    clock = ManualClock()

    async def main():
        async with SolveServer(max_batch=1, num_epochs=EPOCHS, prepare_kwargs=PREP_KW,
                               clock=clock, breaker_threshold=2,
                               breaker_cooldown_ms=1000.0) as server:
            fp = server.register(problem.A)
            server.faults = server.pool.faults = _injector(
                FaultRule(site="solve", kind="error", times=3), clock=clock)
            opts = SubmitOptions(max_retries=0)
            out = {}
            with pytest.raises(SolveFailure) as e0:
                await server.submit(fp, B[:, 0], opts)
            out["r0"] = e0.value
            out["r1"] = await server.submit(fp, B[:, 1], opts)
            with pytest.raises(SolveFailure) as e2:
                await server.submit(fp, B[:, 2], opts)
            out["r2"] = e2.value
            clock.advance(1.1)
            out["r3"] = await server.submit(fp, B[:, 3], opts)
            v = server.metrics.value
            out["transitions"] = {to: int(v("server_breaker_transitions_total", to=to))
                                  for to in ("open", "half_open", "closed")}
            return out, server.stats()

    out, stats = _run(main())
    assert out["r0"].reason == "error"
    np.testing.assert_allclose(out["r1"].x, xs[:, 1], atol=1e-3)
    assert out["r1"].attempts == 2
    assert out["r2"].reason == "breaker_open" and out["r2"].attempts == 0
    np.testing.assert_allclose(out["r3"].x, xs[:, 3], atol=1e-3)
    assert out["transitions"] == {"open": 1, "half_open": 1, "closed": 1}
    assert stats["failed_requests"] == 2


def test_timeout_budget_bounds_the_ladder(problem, rhs_batch):
    B, _ = rhs_batch
    clock = ManualClock()

    async def main():
        async with SolveServer(max_batch=1, num_epochs=EPOCHS, prepare_kwargs=PREP_KW,
                               clock=clock, backoff_base_ms=10.0) as server:
            fp = server.register(problem.A)
            server.faults = server.pool.faults = _injector(
                FaultRule(site="solve", kind="error"), clock=clock)
            with pytest.raises(SolveFailure) as exc:
                await server.submit(fp, B[:, 0], SubmitOptions(max_retries=8, timeout_ms=25.0))
            return exc.value, server.stats()

    failure, stats = _run(main())
    assert failure.reason == "timeout" and failure.attempts <= 3
    assert stats["failed_requests"] == 1


def test_cancelled_request_cannot_poison_or_stall_its_batch(problem, rhs_batch):
    B, xs = rhs_batch

    async def main():
        async with SolveServer(max_batch=4, max_wait_ms=60.0, num_epochs=EPOCHS,
                               prepare_kwargs=PREP_KW) as server:
            fp = server.register(problem.A)
            doomed = server.next_request_seq + 1
            server.faults = server.pool.faults = _injector(
                FaultRule(site="solve", kind="error", request=doomed))
            tasks = [asyncio.ensure_future(server.submit(fp, B[:, i])) for i in range(3)]
            await asyncio.sleep(0.005)
            tasks[1].cancel()
            return await asyncio.gather(*tasks, return_exceptions=True), server.stats()

    results, stats = _run(main())
    assert isinstance(results[1], asyncio.CancelledError)
    for i in (0, 2):
        np.testing.assert_allclose(results[i].x, xs[:, i], atol=1e-3)
    assert stats["cancelled"] >= 1 and stats["failed_requests"] == 0
    assert stats["failures"] == 0 and stats["requests"] == 2


# -- checkpoint quarantine ----------------------------------------------------


@pytest.mark.parametrize("damage", ["truncate", "foreign"])
def test_damaged_checkpoint_quarantined_and_never_reread(tmp_path, prepared, damage):
    store = CheckpointStore(tmp_path)
    target = store.path("fp")
    if damage == "truncate":
        assert store.save("fp", prepared, dict(PREP_KW))
        raw = target.read_bytes()
        bad_bytes = raw[: len(raw) // 2]
    else:
        bad_bytes = b"this was never an npz"
    target.write_bytes(bad_bytes)
    assert store.load("fp", dict(PREP_KW)) is None
    assert store.quarantined == 1 and store.load_misses == 1
    bad = target.with_name(target.name + ".bad")
    assert bad.exists() and not target.exists() and bad.read_bytes() == bad_bytes
    assert store.load("fp", dict(PREP_KW)) is None
    assert store.quarantined == 1 and store.load_misses == 1


def test_config_mismatch_misses_without_quarantine(tmp_path, prepared):
    store = CheckpointStore(tmp_path)
    assert store.save("fp", prepared, dict(PREP_KW))
    assert store.load("fp", dict(PREP_KW, num_blocks=4)) is None
    assert store.quarantined == 0 and store.load_misses == 1 and store.path("fp").exists()
    assert store.load("fp", dict(PREP_KW)) is not None


def test_injected_corruption_quarantines_and_pool_reprepares(tmp_path, problem):
    fp_target = matrix_fingerprint(problem.A)
    faults = _injector(FaultRule(site="checkpoint.load", kind="corrupt",
                                 fingerprint=fp_target, after=1, times=1))
    pool = PreparedPool(max_size=1, checkpoint=str(tmp_path), faults=faults, **PREP_KW)
    fp = pool.register(problem.A)
    assert fp == fp_target
    pool.get(fp)
    pool.get(pool.register(make_problem(n=48, m=192, seed=0, dtype=np.float32).A))
    assert pool.get(fp) is not None
    assert pool.checkpoint.quarantined == 1
    assert pool.stats.prepares == 3 and pool.stats.restores == 0
    assert pool.checkpoint.path(fp).with_name(f"{fp}.npz.bad").exists()
    assert pool.checkpoint.path(fp).exists()


def test_injected_io_errors_do_not_quarantine(tmp_path, prepared):
    faults = _injector(FaultRule(site="checkpoint.load", kind="error", times=1),
                       FaultRule(site="checkpoint.save", kind="error", after=1))
    store = CheckpointStore(tmp_path, faults=faults)
    assert store.save("fp", prepared, dict(PREP_KW))
    assert store.load("fp", dict(PREP_KW)) is None
    assert store.load_misses == 1 and store.quarantined == 0 and store.path("fp").exists()
    assert store.load("fp", dict(PREP_KW)) is not None
    assert not store.save("fp2", prepared, dict(PREP_KW))
    assert not store.path("fp2").exists() and not list(tmp_path.glob("*.tmp"))


def test_refused_placement_raises_and_keeps_the_file(tmp_path, prepared, monkeypatch):
    """A restore onto the card without one fails loudly: the file is not at
    fault, so it is neither quarantined nor counted as a miss, and nothing
    restores onto the CPU instead."""
    store = CheckpointStore(tmp_path)
    kw = dict(JAX_KW)  # device=None: the card
    assert store.save("fp", prepared, kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        store.load("fp", kw)
    assert store.quarantined == 0 and store.load_misses == 0 and store.path("fp").exists()


def test_concurrent_writers_never_expose_a_torn_checkpoint(tmp_path, prepared, monkeypatch):
    """Four writers of one fingerprint, each stopped with half of its file
    written, while the reader loads; then released one at a time, the
    reader loading after each. The writers and the reader are ordered by
    events, not by sleeps: every load sees a whole checkpoint, nothing is
    quarantined and no temp file is left."""
    store = CheckpointStore(tmp_path)
    kw = dict(PREP_KW)
    assert store.save("fp", prepared, kw)  # the checkpoint readers start from
    writers = 4
    halfway = [threading.Event() for _ in range(writers)]
    release = [threading.Event() for _ in range(writers)]
    index = {}
    savez = np.savez

    def gated_savez(f, **arrays):  # the writer's bytes, half, then a stop
        buf = io.BytesIO()
        savez(buf, **arrays)
        data = buf.getvalue()
        i = index[threading.get_ident()]
        f.write(data[: len(data) // 2])
        f.flush()
        halfway[i].set()
        assert release[i].wait(30)
        f.write(data[len(data) // 2:])

    monkeypatch.setattr(tcheckpoint.np, "savez", gated_savez)
    results = [None] * writers

    def writer(i):
        index[threading.get_ident()] = i
        results[i] = store.save("fp", prepared, kw)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(writers)]
    reader = CheckpointStore(tmp_path)
    loads = []
    try:
        for t in threads:
            t.start()
        for e in halfway:
            assert e.wait(30)
        assert len(list(tmp_path.glob("*.tmp"))) == writers  # four torn temp files
        loads.append(reader.load("fp", kw))
        for i, t in enumerate(threads):
            release[i].set()
            t.join(30)
            assert not t.is_alive()
            loads.append(reader.load("fp", kw))
    finally:
        for e in release:
            e.set()
        for t in threads:
            t.join(30)
    assert results == [True] * writers
    assert all(p is not None for p in loads) and len(loads) == writers + 1
    assert reader.quarantined == 0 and reader.load_misses == 0
    assert not list(tmp_path.glob("*.tmp"))
    want = prepared.solve(np.ones(384, np.float32), num_epochs=20).x
    assert np.array_equal(loads[-1].solve(np.ones(384, np.float32), num_epochs=20).x, want)
