"""Seconds from the process's start to the window's start: imports, CUDA
start, inputs, prepare, the kernels' build on a first run, the warm-up."""


def read(ctx):
    return ctx.setup_s
