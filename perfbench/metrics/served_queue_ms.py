"""Mean ``RequestResult.queue_ms`` (enqueue to batch dispatch, the server's
clock) of the requests due before the traced stretch."""
import numpy as np

from perfbench.harness.readers import is_served, served_results


def read(ctx):
    res = served_results(ctx) if is_served(ctx) else []
    return float(np.mean([r.queue_ms for r in res])) if res else None
