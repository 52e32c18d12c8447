"""Epochs a solve ran after its last column froze under ``tol``: what the
host's lead over the card costs the consensus loop
(``solver_overrun_epochs_total`` / ``solver_solves_total``, the program's
process registry)."""
from perfbench.harness import program
from perfbench.harness.readers import is_served


def read(ctx):
    return None if is_served(ctx) else program.per_solve("solver_overrun_epochs_total")
