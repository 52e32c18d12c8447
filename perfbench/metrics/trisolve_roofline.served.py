"""``trisolve_kernel``'s share of its roofline: the least time of one
call from its shapes over its mean device time per call, in the served
cells."""
from perfbench.harness.readers import is_served, trisolve_roofline


def read(ctx):
    if not is_served(ctx):
        return None
    return trisolve_roofline(ctx)
