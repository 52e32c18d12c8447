"""Calls per solve that block the host on the device: each blocking copy
in and out and the synchronize (``solver_host_syncs_total`` /
``solver_solves_total``, the program's process registry)."""
from perfbench.harness import program
from perfbench.harness.readers import is_served


def read(ctx):
    return None if is_served(ctx) else program.per_solve("solver_host_syncs_total")
