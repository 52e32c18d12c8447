"""The reader ``overrun_epochs_per_solve``: the program's
``solver_overrun_epochs_total`` per solve in a closed cell, None in a
served cell and where the program has no such counter, and a traced run of
the harness on the CPU that reports it."""
import time
import types

import pytest

from perfbench.harness import cell as cell_mod
from perfbench.tests import tiny

NAME = "overrun_epochs_per_solve"


@pytest.fixture
def registry(monkeypatch):
    """A fresh process registry in the program's place."""
    from repro_torch.obs import metrics

    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "REGISTRY", reg)
    return reg


def _ctx(served=False):
    return types.SimpleNamespace(window=types.SimpleNamespace(
        latencies_ms=[1.0] if served else None, results=[], clean=None))


def test_reads_the_counter_per_solve(registry):
    registry.counter("solver_solves_total").inc(4)
    registry.counter("solver_overrun_epochs_total").inc(26)
    read = cell_mod.reader("metrics", NAME)
    assert read(_ctx()) == 6.5
    assert read(_ctx(served=True)) is None


def test_reads_none_without_the_counter(registry, monkeypatch):
    from repro_torch.obs import metrics

    read = cell_mod.reader("metrics", NAME)
    assert read(_ctx()) is None  # registered nothing
    registry.counter("solver_solves_total").inc(4)
    assert read(_ctx()) is None  # a program without the counter
    monkeypatch.delattr(metrics, "REGISTRY")
    assert read(_ctx()) is None


def test_traced_tol_run_reports_it(registry):
    """On the CPU each poll is read at once: a tol solve stops at the
    first poll after its last freeze, fewer than ``POLL_EVERY`` epochs on."""
    from repro_torch.core import consensus

    c = tiny.cell("tol")
    c.per_layer.append(NAME)
    c.units[NAME] = "epochs/solve"
    out = cell_mod.run_cell(c, 2 ** 33 + 19, 1.0, True, "cpu", time.perf_counter())
    assert out["correct"] is True
    assert 0 <= out["metrics"][NAME]["value"] < consensus.POLL_EVERY
