"""Observability of the port: metrics registry, request tracing, per-block
convergence diagnostics, and the one monotonic clock every latency number
comes from (the JAX package's ``repro.obs``, copied: these modules are
pure Python and import neither jax nor ``repro``).

Tracing is off unless a ``Tracer`` is passed in (the hot paths test
``tracer is None``), metrics are in-process counter bumps behind one lock,
and spans are host-side only. ``audit_epoch_collectives`` counts the
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
from repro_torch.obs.metrics import MetricsRegistry, start_exposition
from repro_torch.obs.trace import Tracer

__all__ = [
    "clock",
    "MetricsRegistry",
    "start_exposition",
    "Tracer",
    "audit_epoch_collectives",
    "block_residual_history",
    "collect_reduces",
    "convergence_report",
    "per_block_rates",
]
