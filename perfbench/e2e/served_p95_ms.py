"""The 95th percentile of every due request's time from its due moment to
its result; a failed request counts with the whole time it was waited for."""
from perfbench.harness.readers import p95


def read(ctx):
    lat = ctx.window.latencies_ms
    if lat is None or lat.size == 0:
        return None
    return p95(lat)
