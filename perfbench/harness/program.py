"""What the metric readers read from the program's own process: the
solver's counters in ``repro_torch.obs.metrics.REGISTRY`` (bumped once per
``PreparedSolver.solve``, warm-up included) and the served requests'
``RequestResult.worker_idle_ms``. Each returns None where the program has
no such counter or field, as a checkout older than them has not."""
from __future__ import annotations

import numpy as np

from perfbench.harness.readers import served_results


def registry():
    """The program's process registry, or None."""
    from repro_torch.obs import metrics

    return getattr(metrics, "REGISTRY", None)


def counter(name: str) -> float | None:
    """The sum over the label series of counter ``name``, or None where
    the registry or the counter is absent."""
    reg = registry()
    if reg is None or reg.get(name) is None:
        return None
    return reg.total(name)


def active_column_share() -> float | None:
    """100 × active column-epochs over column-epochs."""
    active = counter("solver_active_column_epochs_total")
    total = counter("solver_column_epochs_total")
    if active is None or not total:
        return None
    return 100.0 * active / total


def per_solve(name: str, scale: float = 1.0) -> float | None:
    """Counter ``name`` per completed solve, times ``scale``."""
    value, solves = counter(name), counter("solver_solves_total")
    if value is None or not solves:
        return None
    return scale * value / solves


def worker_idle_ms(ctx) -> float | None:
    """Mean ``worker_idle_ms`` over the clean served batches, a batch
    being the requests that share one (solve_ms, batch_size), as
    ``readers.served_batches`` groups them."""
    batches: dict = {}
    for res in served_results(ctx):
        idle = getattr(res, "worker_idle_ms", None)
        if idle is None:
            return None
        batches[(res.solve_ms, res.batch_size)] = float(idle)
    return float(np.mean(list(batches.values()))) if batches else None
