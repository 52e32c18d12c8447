"""Seconds of ``prepare`` (partition, per-block QR), by the harness's clock,
ending in a device synchronize."""


def read(ctx):
    return ctx.prepare_s
