"""Observability of the port: metrics registry, request tracing, per-block
convergence diagnostics, and the one monotonic clock every latency number
comes from (the JAX package's ``repro.obs``, copied, with the solver's
phases and counters added; they import neither jax nor ``repro``).

Tracing is off unless a ``Tracer`` is passed in or ``torch.profiler``
records: each entry point (``prepare``, ``PreparedSolver.solve``, a served
batch) checks once (``trace.recorder``). Spans cover the serving layer
(queue, batch, ``batch.assemble``, ``batch.deliver``, pool IO) and the
dense solver's phases (``solver.prepare`` with its partition / QR /
projector / spectra / wait, ``solver.solve`` with its rhs / init / epochs /
wait / fetch; one span for the epoch loop, none per epoch), each linked to
its parent. ``trace.phase`` bridges them to the device trace: while the
profiler records, each phase is also a host range of the same name, so the
profiler names the card's idle gaps by program phase. Metrics are
in-process counter bumps behind one lock; ``metrics.REGISTRY`` is the
process registry, where each solve bumps the ``solver_*_total`` counters
(solves, epochs, column-epochs, active column-epochs, host syncs, bytes
copied each way) once, on the host. ``audit_epoch_collectives`` counts the
all-reduces in one epoch of a sharded solver.
"""
from repro_torch.obs import clock
from repro_torch.obs.convergence import (
    audit_epoch_collectives,
    block_residual_history,
    collect_reduces,
    convergence_report,
    per_block_rates,
)
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry, start_exposition
from repro_torch.obs.trace import Tracer, phase, recorder

__all__ = [
    "clock",
    "MetricsRegistry",
    "REGISTRY",
    "start_exposition",
    "Tracer",
    "phase",
    "recorder",
    "audit_epoch_collectives",
    "block_residual_history",
    "collect_reduces",
    "convergence_report",
    "per_block_rates",
]
