"""Observability of the port: per-block convergence diagnostics."""
from repro_torch.obs.convergence import (
    audit_epoch_collectives,
    block_residual_history,
    convergence_report,
    per_block_rates,
)

__all__ = [
    "audit_epoch_collectives",
    "block_residual_history",
    "convergence_report",
    "per_block_rates",
]
