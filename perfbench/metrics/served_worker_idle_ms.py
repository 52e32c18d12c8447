"""Mean ``RequestResult.worker_idle_ms`` (the worker thread free while a
batch's oldest request waited, the server's clock) over the clean served
batches."""
from perfbench.harness import program
from perfbench.harness.readers import is_served


def read(ctx):
    return program.worker_idle_ms(ctx) if is_served(ctx) else None
