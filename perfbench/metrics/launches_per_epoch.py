"""Kernels in the device trace over the epochs run there (one
``update_kernel`` execution per epoch)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.window.latencies_ms is not None:
        return None
    epochs = tr.count("update_kernel")
    return tr.kernels / epochs if epochs else None
