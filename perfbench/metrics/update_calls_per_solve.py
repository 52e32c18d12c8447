"""Executions of ``update_kernel`` in the device trace over the solves traced
(one per epoch; counted on the device, so a graph replay counts too)."""


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or w.latencies_ms is not None or w.traced_solves == 0:
        return None
    return tr.count("update_kernel") / w.traced_solves
