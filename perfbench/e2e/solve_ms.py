"""Milliseconds per batched solve: the window's seconds over the solves
completed in it (closed loop)."""


def read(ctx):
    w = ctx.window
    if w.latencies_ms is not None or w.solves == 0:
        return None
    return 1e3 * w.seconds / w.solves
