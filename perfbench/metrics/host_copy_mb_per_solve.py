"""MB (1e6 bytes) copied per solve between host and device, both ways
(``solver_copy_bytes_total`` / ``solver_solves_total``, the program's
process registry)."""
from perfbench.harness import program
from perfbench.harness.readers import is_served


def read(ctx):
    return None if is_served(ctx) else program.per_solve("solver_copy_bytes_total", 1e-6)
