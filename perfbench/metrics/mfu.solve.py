"""The whole solve's share of the card's roofline: the least time of the
solves' steps (``harness/counts.solve_least_seconds``, at the epochs the
answers needed) over their measured time, in the solve cells."""
from perfbench.harness.readers import is_served, solve_mfu


def read(ctx):
    if is_served(ctx):
        return None
    return solve_mfu(ctx)
