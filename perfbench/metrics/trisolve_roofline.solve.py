"""``trisolve_kernel``'s share of its roofline: the least time of one
call from its shapes over its mean device time per call, in the solve
cells."""
from perfbench.harness.readers import is_served, trisolve_roofline


def read(ctx):
    if is_served(ctx):
        return None
    return trisolve_roofline(ctx)
