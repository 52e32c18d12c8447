"""Mean ``RequestResult.batch_size`` (requests that shared a solve) of the
requests due before the traced stretch."""
import numpy as np

from perfbench.harness.readers import is_served, served_results


def read(ctx):
    res = served_results(ctx) if is_served(ctx) else []
    return float(np.mean([r.batch_size for r in res])) if res else None
