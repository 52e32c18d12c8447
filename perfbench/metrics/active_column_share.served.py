"""100 × the column-epochs the ``tol`` mask let run over all column-epochs
of the served batches, bucket padding included: a padded column freezes at
once (``solver_active_column_epochs_total`` / ``solver_column_epochs_total``,
the program's process registry)."""
from perfbench.harness import program
from perfbench.harness.readers import is_served


def read(ctx):
    return program.active_column_share() if is_served(ctx) else None
