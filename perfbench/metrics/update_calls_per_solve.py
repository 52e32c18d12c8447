"""Executions of ``update_kernel`` in the device trace over the solves traced
(one per epoch; counted on the device, so a graph replay counts too); the
dense solver's kernel, so None on the matrix-free path."""


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or ctx.path != "dense" or w.latencies_ms is not None or w.traced_solves == 0:
        return None
    return tr.count("update_kernel") / w.traced_solves
