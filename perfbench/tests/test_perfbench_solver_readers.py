"""The readers of the program's own counters and spans
(``perfbench/harness/program.py`` and the five metrics on it): their values
on a fake context, None where the program has no such counter or field,
and a traced run of the harness on the CPU that reports them."""
import dataclasses
import time
import types

import pytest

from perfbench.harness import cell as cell_mod
from perfbench.tests import tiny

NEW = ("active_column_share.solve", "active_column_share.served", "host_syncs_per_solve",
       "host_copy_mb_per_solve", "served_worker_idle_ms")
SEED = 2 ** 33 + 17


@pytest.fixture
def registry(monkeypatch):
    """A fresh process registry in the program's place."""
    from repro_torch.obs import metrics

    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "REGISTRY", reg)
    return reg


def _ctx(served=False, results=()):
    window = types.SimpleNamespace(
        latencies_ms=[1.0] * len(results) if served else None,
        results=list(results), clean=None)
    return types.SimpleNamespace(window=window)


def _result(solve_ms, batch_size, idle=None):
    res = types.SimpleNamespace(solve_ms=solve_ms, batch_size=batch_size, queue_ms=1.0,
                                iterations=3)
    if idle is not None:
        res.worker_idle_ms = idle
    return res


def _bump(reg, solves=4, column_epochs=1200, active=300, syncs=28, h2d=8e6, d2h=4e6):
    reg.counter("solver_solves_total").inc(solves)
    reg.counter("solver_column_epochs_total").inc(column_epochs)
    reg.counter("solver_active_column_epochs_total").inc(active)
    reg.counter("solver_host_syncs_total").inc(syncs)
    reg.counter("solver_copy_bytes_total").labels(direction="h2d").inc(h2d)
    reg.counter("solver_copy_bytes_total").labels(direction="d2h").inc(d2h)


def test_counter_readers_read_the_process_registry(registry):
    _bump(registry)
    closed, served = _ctx(), _ctx(served=True, results=[_result(5.0, 2, 0.0)])
    read = {name: cell_mod.reader("metrics", name) for name in NEW}
    assert read["active_column_share.solve"](closed) == 25.0
    assert read["active_column_share.served"](served) == 25.0
    assert read["host_syncs_per_solve"](closed) == 7.0
    assert read["host_copy_mb_per_solve"](closed) == 3.0
    # each reads in its own kind of cell only
    assert read["active_column_share.solve"](served) is None
    assert read["active_column_share.served"](closed) is None
    assert read["host_syncs_per_solve"](served) is None


def test_counter_readers_return_none_without_counters(registry, monkeypatch):
    from repro_torch.obs import metrics

    for name in NEW[:4]:
        ctx = _ctx(served=name.endswith(".served"), results=[_result(5.0, 2)])
        assert cell_mod.reader("metrics", name)(ctx) is None  # registered nothing
    monkeypatch.delattr(metrics, "REGISTRY")  # a program without the registry
    for name in NEW[:4]:
        ctx = _ctx(served=name.endswith(".served"), results=[_result(5.0, 2)])
        assert cell_mod.reader("metrics", name)(ctx) is None


def test_worker_idle_is_a_mean_over_batches():
    read = cell_mod.reader("metrics", "served_worker_idle_ms")
    results = [_result(10.0, 3, 6.0)] * 3 + [_result(12.0, 1, 0.0)] + [_result(11.0, 2, 3.0)] * 2
    assert read(_ctx(served=True, results=results)) == 3.0
    assert read(_ctx(served=True, results=[_result(10.0, 3)] * 3)) is None  # no such field
    assert read(_ctx(served=True, results=[])) is None
    assert read(_ctx()) is None


@pytest.mark.parametrize("kind", ["tol", "served"])
def test_traced_run_reports_the_new_metrics(kind, registry):
    c = tiny.cell(kind)
    mine = [n for n in NEW if (n.endswith(".served") or n == "served_worker_idle_ms")
            == (kind == "served")]
    c = dataclasses.replace(c, per_layer=c.per_layer + mine,
                            units={**c.units, **{n: "u" for n in mine}})
    out = cell_mod.run_cell(c, SEED, 1.0, True, "cpu", time.perf_counter())
    assert out["correct"] is True
    got = out["metrics"]
    assert set(mine) <= set(got)
    if kind == "tol":
        assert 0 < got["active_column_share.solve"]["value"] < 100
        assert got["host_syncs_per_solve"]["value"] == 7.0
        # float32 (J, p, k) in with γ and η; (n, k) and (E + 1, k) out
        J, p, n, k, epochs = 8, 25, 64, 4, 300
        want = (J * p * k * 4 + 8 + (n * k + (epochs + 1) * k) * 4) / 1e6
        assert got["host_copy_mb_per_solve"]["value"] == pytest.approx(want)
    else:
        assert 0 < got["active_column_share.served"]["value"] < 100
        assert got["served_worker_idle_ms"]["value"] >= 0.0
