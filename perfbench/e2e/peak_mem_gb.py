"""The device's peak allocation over the window, in GB (1e9 bytes): what the
prepared solver holds plus what its solves allocate."""


def read(ctx):
    return ctx.window.peak_bytes / 1e9
