"""The consensus-update pair's share of its roofline: the least time of one
launch pair from its shapes over the mean device time of ``wv_kernel`` +
``update_kernel`` per pair, in the served cells."""
from perfbench.harness.readers import consensus_update_roofline, is_served


def read(ctx):
    if not is_served(ctx):
        return None
    return consensus_update_roofline(ctx)
