"""The device's idle share of the traced stretch: 1 − (union of the device
operations' intervals) / (the stretch), in %, in the solve cells."""
from perfbench.harness.readers import idle_share, is_served


def read(ctx):
    if is_served(ctx):
        return None
    return idle_share(ctx)
